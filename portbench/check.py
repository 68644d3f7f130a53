"""Whether what the timed path produced is correct.

After the window, the cell's program kind's ``Reference``
(``programs/<kind>.py``) makes each sampled frame again from the same
inputs, drawn anew from the seed, and two numbers are compared, each
against the cell's limit (``workloads/<cell>.json``, ``check.limits``):

* ``pixels_off``: the share of the sampled frames' pixels whose value
  differs from the reference's in any channel;
* ``counters_off``: the largest relative gap, over the frames and the
  frame's counters, ``|program - reference| / max(reference, 1)``; 0 for
  frames whose kind keeps no counters.

``Reference(..., precision="control")`` is the control, which the limits
must fail (``tools/readings.py``, ``tests/``).
"""
from __future__ import annotations

from typing import Dict, List

NUMBERS = ("pixels_off", "counters_off")


def numbers(pairs) -> Dict[str, float]:
    """The compared numbers over ``[(program image, program counters,
    reference image, reference counters)]``, host tensors; images
    ``[H, W, C]``."""
    off = total = 0
    worst = 0.0
    for img, cnt, ref_img, ref_cnt in pairs:
        off += int((img != ref_img).any(dim=-1).sum())
        total += ref_img.shape[0] * ref_img.shape[1]
        if ref_cnt.numel() or cnt.numel():
            gap = ((cnt - ref_cnt).abs().double()
                   / ref_cnt.abs().clamp_min(1))
            worst = max(worst, float(gap.max()))
    return {"pixels_off": off / max(total, 1), "counters_off": worst}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Each number at or under its limit."""
    return all(values[k] <= limits[k] for k in NUMBERS)


def lines(values: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {values[k]!r} limit {limits[k]!r}" for k in NUMBERS]
