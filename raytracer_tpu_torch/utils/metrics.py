"""Run logging: a JSONL metrics stream and a CSV table writer.

Counterpart of ``raytracer_tpu/utils/metrics.py``'s ``RunLogger`` and
``write_csv`` (the per-comparison ``statistics.json`` is written by
``compare/harness.py``, the experiment's summaries by
``compare/experiment.py``).
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Mapping, Sequence


class RunLogger:
    """Append-only JSONL metrics stream, one dict a step or event."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_csv(path, rows: Sequence[Mapping]):
    """A table of dicts as CSV, header from the first row's keys
    (``agent_analysis.csv``'s layout); an empty file for no rows."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        path.write_text("")
        return
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        for r in rows:
            w.writerow(r)
