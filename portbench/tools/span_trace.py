"""Traced runs of a cell read with the program's own spans and counters,
on the card:

    python3 portbench/tools/span_trace.py --workload <cell> --seeds 1-3 \
        [--seconds 10] [--out FILE]

Each seed is one ``run.py --trace 1`` run (``harness.run_cell``) with
``spans.SpanTracer`` in place of ``tracing.Tracer`` and the metrics of
``METRICS`` after the benchmark's own, in one process.  One JSON line a
seed: the result line as that run prints it, and beside it the traced
frames and their time, the program's counters over them, the idle
seconds under each program span, the idle seconds under
``portbench.render`` by how far program spans name them, the program's
and the harness's spans mirrored onto the device's timeline, and
``tracing.reduce``'s reading of the same events (as the benchmark's own
traced run reads them).  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from portbench import harness, manifest, spans, tracing  # noqa: E402
from portbench.tools.readings import seeds  # noqa: E402

# The per-layer metrics that read the program's spans and counters: cells
# that report them, as BENCHMARK.json would list them.
AGENT = ["fb_agent_hybrid_200x100", "fb_agent_stepwise_gml3_200x100"]
ALL = ["student_guided_800x600", "student_traditional_800x600"] + AGENT
METRICS = [
    {"name": "trace_setup_idle_share", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "trace.path",
     "moves": "samples_per_s", "workloads": ALL},
    {"name": "host_reads_per_frame", "unit": "reads/frame",
     "better": "lower", "source": "program_counter", "layer": "trace.path",
     "moves": "samples_per_s", "workloads": ALL},
    {"name": "level_step_idle_share", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "core.cuda_path",
     "moves": "samples_per_s", "workloads": AGENT},
    {"name": "guide_steered_share", "unit": "%", "better": "higher",
     "source": "program_counter", "layer": "fb.inference",
     "moves": "samples_per_s", "workloads": AGENT},
]


class Tracer(spans.SpanTracer):
    """The harness's tracer for these runs: ``main`` puts it in
    ``tracing.Tracer``'s place, where ``run_cell`` takes it from, with the
    cell's program kind's ``counters``."""
    last = None          # (the last run's tracer, its record)

    def record(self):
        rec = super().record()
        Tracer.last = (self, rec)
        return rec


def render_idle(gaps) -> dict:
    """Idle seconds under ``portbench.render``: all, those that no program
    span names, and those whose innermost program span is the whole
    frame's (``raytracer.render``: in ``render_path`` but no finer span)."""
    out = {"render_idle_s": 0.0, "render_idle_unnamed_s": 0.0,
           "render_idle_frame_only_s": 0.0}
    for name, s in gaps:
        parts = name.split("/")
        if parts[0] != tracing.SPAN + "render":
            continue
        out["render_idle_s"] += s
        inner = parts[1] if len(parts) > 1 else ""
        if not inner.startswith(spans.PROGRAM):
            out["render_idle_unnamed_s"] += s
        elif inner == spans.PROGRAM + "render":
            out["render_idle_frame_only_s"] += s
    return out


def one(cell: dict, seed: int, seconds: float, bench: dict) -> dict:
    t_start = time.perf_counter()
    Tracer.last = None
    result = harness.run_cell(cell, seed, seconds, True, device="cuda",
                              t_start=t_start, bench=bench)
    result.pop("lines")
    t, rec = Tracer.last
    old = tracing.reduce(t.events, t.traced)
    return {"seed": seed, "result": result, "traced_frames": t.traced,
            "traced_frame_ms": rec.frame_s * 1e3 if rec else None,
            "counters": t.deltas,
            "span_idle_s": rec.span_idle_s if rec else None,
            **render_idle(rec.gaps if rec else []),
            "program_mirrors": sum(1 for n, dev, _, _ in t.events
                                   if dev and n.startswith(spans.PROGRAM)),
            "harness_mirrors": sum(1 for n, dev, _, _ in t.events
                                   if dev and n.startswith(tracing.SPAN)),
            "tracing_reduce": None if old is None else {
                "busy_s": old.busy_s, "window_s": old.window_s,
                "device_idle_share": 100.0 * (1 - old.busy_s / old.window_s),
                "gaps_s": sum(s for _, s in old.gaps)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_trace: CUDA is not available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    bench = manifest.benchmark()
    have = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] += [m for m in METRICS if m["name"] not in have]
    cell = manifest.cell(args.workload)
    Tracer.counters = staticmethod(
        manifest.program(cell["config_data"]["program"]).counters)
    tracing.Tracer = Tracer
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds(args.seeds):
            line = json.dumps({"workload": args.workload,
                               **one(cell, seed, args.seconds, bench)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
