"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell ``<name>`` is ``workloads/<name>.json`` (its configuration, traffic
mix, chips, why, and the limits its outputs are held to); its
configuration is ``configs/<config>.json``, which names the program kind
that runs it (``"program"``: ``programs/<program>.py``, the system under
test set up for a cell with its plain reference and its unit count); its
traffic mix ``mixes/<traffic>.json`` (the parameters of one traffic kind),
the kind's loop ``traffic/<kind>.py``, and each metric's reader
``metrics/<metric>.py``.  Everything is found by name: a cell, a mix, a
metric or a program kind is added by adding files, and ``BENCHMARK.json``
lists what runs.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, base: Path = HERE) -> dict:
    """The cell, with its configuration and mix filled in under
    ``config_data`` and ``mix``."""
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    path = base / "workloads" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no cell {name!r} ({path})")
    c = load_json(path)
    config = base / "configs" / f"{c['config']}.json"
    c["config_data"] = load_json(config)
    if "program" not in c["config_data"]:
        raise KeyError(f"{config} names no program kind (\"program\")")
    c["mix"] = load_json(base / "mixes" / f"{c['traffic']}.json")
    return c


def metrics_for(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those with no ``workloads`` key, and those that
    list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
    if not NAME.match(metric):
        raise ValueError(f"not a metric name: {metric!r}")
    module = metric.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"portbench.metrics.{module}").read


def traffic(kind: str):
    """The traffic kind's module (``traffic/<kind>.py``)."""
    if not NAME.match(kind):
        raise ValueError(f"not a traffic kind: {kind!r}")
    return importlib.import_module(f"portbench.traffic.{kind}")


def program(kind: str):
    """The program kind's module (``programs/<kind>.py``): ``Session``,
    ``Reference`` and ``samples_per_frame``, as ``programs/__init__.py``
    sets out."""
    if not NAME.match(kind):
        raise ValueError(f"not a program kind: {kind!r}")
    return importlib.import_module(f"portbench.programs.{kind}")
