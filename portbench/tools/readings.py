"""The readings the limits of ``check.py`` are set from, on the card:

    python3 portbench/tools/readings.py --workload <cell> --seeds 1-12 \
        --control-seeds 1-3 --seconds 3 [--out FILE]

For each seed, in one process: the program's run as ``run.py`` makes it
(set-up, a short window at the cell's own load, the seeded sample of its
frames) and the numbers the comparison with the reference gives (the
lower reading).  For each control seed, on the same frames: the control,
the reference at the precision below the configuration's put in the
program's place (the upper reading), and where the program's products
are float32 with TF32 off, the program itself with TF32 on.  The
reference and the control are the cell's program kind's
(``programs/<kind>.py``).  One JSON line a seed.  The benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from portbench import check, manifest  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            out += range(int(a), int(b) + 1)
        elif part:
            out.append(int(part))
    return out


def readings(cell: dict, seed: int, seconds: float, control: bool,
             device="cuda") -> dict:
    t0 = time.perf_counter()
    traffic = manifest.traffic(cell["mix"]["kind"])
    kind = manifest.program(cell["config_data"]["program"])
    session = kind.Session(cell, seed, device, trace=False)
    traffic.warm_up(session)
    keep = traffic.Reservoir(cell["check"]["frames"], seed)
    _, frames = traffic.window(session, seconds, keep)
    kept = sorted(keep.items, key=lambda t: t[0])
    out = {"seed": seed, "frames": len(frames),
           "compared": [i for i, _, _ in kept]}
    tf32_outputs = None
    if control and device != "cpu" and kind.has_tf32_path(cell):
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_outputs = [session.render(session.planes(i)) for i, _, _ in kept]
        torch.backends.cuda.matmul.allow_tf32 = False
    inputs = session.inputs
    session.close()
    ref = kind.Reference(cell, seed, device, inputs)
    refs = [ref.frame(i) for i, _, _ in kept]
    out["program"] = check.numbers(
        [(img, cnt, *r) for (_, img, cnt), r in zip(kept, refs)])
    out["counters"] = [r[1].tolist() for r in refs]
    if control:
        ctl = kind.Reference(cell, seed, device, inputs, precision="control")
        out["control"] = check.numbers(
            [(*ctl.frame(i), *r) for (i, _, _), r in zip(kept, refs)])
        if tf32_outputs is not None:
            out["program_tf32"] = check.numbers(
                [(*o, *r) for o, r in zip(tf32_outputs, refs)])
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cell = manifest.cell(args.workload)
    controls = set(seeds(args.control_seeds))
    out = open(args.out, "a") if args.out else None
    for s in seeds(args.seeds):
        line = json.dumps({"workload": args.workload,
                           **readings(cell, s, args.seconds, s in controls)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
