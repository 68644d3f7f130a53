"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, the result line.

``main`` is the command's body on the card.  ``run_cell`` does the work
for any device, so the tests drive whole runs on the CPU at small sizes
(with the timed path broken underneath, to see ``correct`` turn false).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from typing import List, Optional

import torch

from . import check, manifest
from .record import Run

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "raytracer_tpu")


def Session(cell: dict, seed: int, device, trace: bool, tracer=None):
    """The program set up for a cell by its kind (the configuration's
    ``program``), with the harness's draws."""
    return manifest.program(cell["config_data"]["program"]).Session(
        cell, seed, device, trace, tracer)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, bench: dict,
             min_frames: int = 1) -> dict:
    """One run: the result line's fields, with ``check`` and ``lines``
    (the compared numbers beside their limits)."""
    from .tracing import Tracer
    name, mix, cfg = cell["name"], cell["mix"], cell["config_data"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = cfg["precision"]["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["precision"]["tf32"]
    traffic = manifest.traffic(mix["kind"])
    kind = manifest.program(cfg["program"])
    tracer = Tracer(seconds) if trace and cuda else None
    phases = {"imports": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
    phases["device"] = time.perf_counter() - t_start
    session = kind.Session(cell, seed, dev, trace, tracer)
    phases["program"] = time.perf_counter() - t_start
    traffic.warm_up(session)
    if tracer is not None:
        Tracer.warm_up(lambda: session.render(session.planes(-3)))
    session.setup_done()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    phases["warm_up"] = setup_s

    keep = traffic.Reservoir(cell["check"]["frames"], seed)
    start, frames = traffic.window(session, seconds, keep, tracer,
                                   min_frames=min_frames)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    forbidden = forbidden_modules()
    if forbidden:
        raise ForbiddenModules(forbidden)
    fields, inputs = session.run_fields(), session.inputs
    session.close()
    del session
    if cuda:
        torch.cuda.empty_cache()

    ref = kind.Reference(cell, seed, dev, inputs, count_work=trace)
    pairs = []
    for index, image, counters in sorted(keep.items, key=lambda t: t[0]):
        ref_image, ref_counters = ref.frame(index)
        pairs.append((image, counters, ref_image, ref_counters))
    values = check.numbers(pairs)
    limits = cell["check"]["limits"]
    correct = check.judge(values, limits)

    run = Run(cfg, mix, samples_per_frame=kind.samples_per_frame(cell),
              setup_s=setup_s, window_start=start, frames=frames,
              trace=tracer.record() if tracer else None,
              work=ref.work_per_frame(), **fields)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_for(bench, name, section):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(frames), "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    if cuda:
        result["card"] = power_limit()
    result["setup_phases_s"] = phases
    result["check"] = {k: {"value": values[k], "limit": limits[k]}
                       for k in check.NUMBERS}
    result["lines"] = check.lines(values, limits)
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"the run holds forbidden modules: {names}")
        self.names = names


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="One run of one benchmark cell "
                                "of raytracer_tpu_torch on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = manifest.benchmark()
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} card(s) needed, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_start=t_start, bench=bench)
    except ForbiddenModules as e:
        print(f"portbench: forbidden modules loaded: {', '.join(e.names)}; "
              "no result", file=sys.stderr)
        return 3
    lines = result.pop("lines")
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0
