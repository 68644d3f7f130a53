"""The chandelier teacher recipe over seeds, and the guided chunk's training
hit rate compared between two sets of teachers.

    python3 -m raytracer_tpu_torch.tools.teacher_sweep train --seeds 12-39 \\
        [--parallel 4] [--scenes 320] [--render] [--out build/sweep]
    python3 -m raytracer_tpu_torch.tools.teacher_sweep compare \\
        --a build/sweep/s*.json [--a-rates 3.2 ...] \\
        --b W/*/final_training_report.json [--b-rates 3.4 ...]

``train`` runs ``ship_models train-chandelier --scenes N --seed S`` for
each seed, ``--parallel`` processes at once (``OMP_NUM_THREADS=1`` each;
four at once on one card take ~163 s at 320 scenes), teachers and work
directories under ``--out``.  With ``--render``, each teacher of a batch
then renders as a full guide (``ship_models eval --scene chandelier
--size 200x100 --spp 8 --seed 5``) while the next batch trains.  Each seed
gets ``OUT/sS.json``: the guided chunk's training hit rate (``rate``), the
quarter means, the hit rates of every scene, the wall seconds, the card's
name and power limit (``nvidia-smi``), and with ``--render`` the
teacher's and the traditional frame's small-light hits.

``compare`` reads a set's rates from such summaries, from a trainer's
``final_training_report.json`` (either package's) or as numbers, and
prints one JSON object: each set's count, mean and standard deviation,
Welch's t-test and the two-sided Mann-Whitney U test.

The guided chunk's training hit rate is the mean over the last half of a
run's ``all_performances`` (the ``guide_prob`` 0.5 chunk of
``train-chandelier``), in percent.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np


def hit_rates(report: dict) -> list:
    return [p["hit_rate"] for p in report["all_performances"]]


def guided_rate(rates) -> float:
    """The mean hit rate (percent) of the last half of a run's scenes."""
    rates = list(rates)
    return float(np.mean(rates[len(rates) // 2:]))


def quarter_means(rates) -> list:
    q = len(rates) // 4
    return [float(np.mean(rates[i * q:(i + 1) * q])) for i in range(4)]


def read_rate(path) -> float:
    """A teacher's guided-chunk rate from a ``train`` summary or a training
    report."""
    d = json.loads(Path(path).read_text())
    return float(d["rate"]) if "rate" in d else guided_rate(hit_rates(d))


def parse_seeds(spec: str) -> list:
    """``"12-15,20"`` -> ``[12, 13, 14, 15, 20]``."""
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def card() -> str | None:
    """``name, power.limit`` of the first card from ``nvidia-smi``; None
    where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _recipe(*argv) -> list:
    return [sys.executable, "-m", "raytracer_tpu_torch.tools.ship_models",
            *map(str, argv)]


def _render(out: Path, seed: int, device: str) -> dict:
    work = out / f"w{seed}" / "eval"
    with open(out / "logs" / f"eval_s{seed}.log", "w") as log:
        subprocess.run(_recipe("eval", "--scene", "chandelier", "--model",
                               out / f"s{seed}.npz", "--size", "200x100",
                               "--spp", 8, "--seed", 5, "--out", work,
                               "--device", device),
                       stdout=log, stderr=subprocess.STDOUT, check=True)
    st = json.loads((work / "statistics.json").read_text())
    return {"traditional_small_light_hits":
            int(st["traditional"]["small_light_hits"]),
            "fb_small_light_hits": int(st["fb"]["small_light_hits"])}


def cmd_train(args):
    out = Path(args.out)
    (out / "logs").mkdir(parents=True, exist_ok=True)
    seeds = parse_seeds(args.seeds)
    gpu = card()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    renders: list = []

    def render_all(batch):
        for s in batch:
            summary = out / f"s{s}.json"
            d = json.loads(summary.read_text())
            d["render"] = _render(out, s, args.device)
            summary.write_text(json.dumps(d, indent=1))

    for i in range(0, len(seeds), args.parallel):
        batch = seeds[i:i + args.parallel]
        t0 = time.perf_counter()
        procs = []
        for s in batch:
            log = open(out / "logs" / f"train_s{s}.log", "w")
            procs.append((s, log, subprocess.Popen(
                _recipe("train-chandelier", "--scenes", args.scenes,
                        "--seed", s, "--out", out / f"s{s}.npz",
                        "--workdir", out / f"w{s}", "--device",
                        args.device, *args.recipe_args),
                stdout=log, stderr=subprocess.STDOUT, env=env)))
        for s, log, p in procs:
            rc = p.wait()
            log.close()
            if rc:
                raise SystemExit(f"train-chandelier seed {s}: exit {rc}")
        seconds = time.perf_counter() - t0
        for s in batch:
            rates = hit_rates(json.loads(
                (out / f"w{s}" / "final_training_report.json").read_text()))
            (out / f"s{s}.json").write_text(json.dumps({
                "seed": s, "scenes": args.scenes, "device": args.device,
                "card": gpu, "rate": guided_rate(rates),
                "quarters": quarter_means(rates),
                "batch": batch, "batch_seconds": seconds,
                "hit_rates": rates}, indent=1))
            print(json.dumps({"seed": s, "rate": guided_rate(rates),
                              "batch_seconds": round(seconds, 1)}),
                  flush=True)
        if args.render:
            renders = [t for t in renders if t.is_alive()]
            t = threading.Thread(target=render_all, args=(batch,))
            t.start()
            renders.append(t)
    for t in renders:
        t.join()
    print(json.dumps({"card": gpu, "seeds": seeds,
                      "rates": [read_rate(out / f"s{s}.json")
                                for s in seeds]}))


def compare(a, b) -> dict:
    """Counts, means and standard deviations of the rates ``a`` and ``b``,
    Welch's t-test and the two-sided Mann-Whitney U test."""
    from scipy import stats
    a, b = np.asarray(a, float), np.asarray(b, float)

    def desc(x):
        return {"n": int(x.size), "mean": float(x.mean()),
                "sd": float(x.std(ddof=1)) if x.size > 1 else None}
    return {"a": desc(a), "b": desc(b),
            "welch_p": float(stats.ttest_ind(a, b, equal_var=False).pvalue),
            "mann_whitney_p": float(stats.mannwhitneyu(
                a, b, alternative="two-sided").pvalue)}


def cmd_compare(args):
    a = [read_rate(p) for p in args.a] + list(args.a_rates)
    b = [read_rate(p) for p in args.b] + list(args.b_rates)
    print(json.dumps(compare(a, b)))


def build_parser():
    p = argparse.ArgumentParser(prog="teacher_sweep")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--seeds", required=True, help="e.g. 12-39 or 1,4,9")
    t.add_argument("--parallel", type=int, default=4)
    t.add_argument("--scenes", type=int, default=320)
    t.add_argument("--render", action="store_true")
    t.add_argument("--out", default="build/sweep")
    t.add_argument("--device", default="cuda")
    t.add_argument("recipe_args", nargs="*",
                   help="more train-chandelier arguments, after --")
    t.set_defaults(fn=cmd_train)
    c = sub.add_parser("compare")
    for side in ("a", "b"):
        c.add_argument(f"--{side}", nargs="*", default=[],
                       help="train summaries or training reports")
        c.add_argument(f"--{side}-rates", nargs="*", type=float, default=[])
    c.set_defaults(fn=cmd_compare)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
