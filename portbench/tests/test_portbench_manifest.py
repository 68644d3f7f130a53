"""The harness as data: BENCHMARK.json keeps the naming rules, every
metric's ``moves`` target is reported where the metric is, every file it
names is there, and a cell added as files is found without an edit."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import pytest

from portbench import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def problems(bench: dict) -> List[str]:
    """What in ``bench`` breaks the benchmark's rules on names, units and
    cross references; empty when it keeps them."""
    out: List[str] = []
    names: Dict[str, set] = {"configs": set(), "workloads": set(),
                             "metrics": set()}
    for c in bench["configs"]:
        names["configs"].add(c["name"])
        for key in [c["name"]] + list(c["reduced"]):
            if not manifest.NAME.match(key):
                out.append(f"config name or reduced key {key!r}")
    for w in bench["workloads"]:
        names["workloads"].add(w["name"])
        for key in (w["name"], w["config"], w["traffic"]):
            if not manifest.NAME.match(key):
                out.append(f"workload name {key!r}")
        if w["config"] not in names["configs"]:
            out.append(f"{w['name']}: no config {w['config']!r}")
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if m["name"] in names["metrics"]:
                out.append(f"metric {m['name']!r} twice")
            names["metrics"].add(m["name"])
            if not manifest.NAME.match(m["name"]):
                out.append(f"metric name {m['name']!r}")
            if not UNIT.match(m["unit"]):
                out.append(f"{m['name']}: unit {m['unit']!r}")
            for w in m.get("workloads", []):
                if w not in names["workloads"]:
                    out.append(f"{m['name']}: no workload {w!r}")
    for section in ("configs", "workloads"):
        if len(names[section]) != len(bench[section]):
            out.append(f"a name in {section} twice")
    return out


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert not problems(BENCH)


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("text", [
    *(c["why"] for c in BENCH["configs"]),
    *(w["why"] for w in BENCH["workloads"]),
    *(c["source"] for c in BENCH["configs"]),
    *(m["layer"] for m in BENCH["per_layer"])])
def test_free_text_is_one_short_line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bad_names_and_units_are_found():
    bad = json.loads(json.dumps(BENCH))
    bad["end_to_end"][0]["unit"] = "samples per s"
    bad["per_layer"][0]["name"] = "frame mfu"
    out = problems(bad)
    assert any("unit" in p for p in out) and any("frame mfu" in p
                                                 for p in out)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_for(BENCH, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(BENCH, w["name"], "per_layer")


def test_moves_target_is_reported_in_each_cell():
    for m in BENCH["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for cell in cells:
            e2e = {x["name"] for x in manifest.metrics_for(
                BENCH, cell, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_agree_with_benchmark(w):
    cell = manifest.cell(w["name"])
    for k in ("config", "traffic", "chips", "why"):
        assert cell[k] == w[k]
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).exists()
    assert cell["config_data"]["reduced"] == cfg["reduced"]
    assert cell["config_data"]["source"] == cfg["source"]
    assert manifest.traffic(cell["mix"]["kind"])
    kind = manifest.program(cell["config_data"]["program"])
    assert all(callable(getattr(kind, name)) for name in
               ("Session", "Reference", "samples_per_frame"))
    for k in ("pixels_off", "counters_off"):
        assert cell["check"]["limits"][k] >= 0


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_config_files_hold_the_program_scene():
    """The configuration's spheres are the port's chandelier scene."""
    from raytracer_tpu_torch.scene.library import chandelier_scene
    from raytracer_tpu_torch.trace.path import scene_spec
    from portbench.reference import plain
    scene, _, _, params = chandelier_scene(device="cpu")
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        rows = plain.scene_rows(data["scene"]["spheres"])
        assert [tuple(r) for r in rows] == list(scene_spec(scene))
        assert tuple(data["scene"]["camera_position"]) == tuple(
            params["camera_position"])
        assert data["scene"]["fov"] == params["fov"]


def test_added_cell_found_without_edits(tmp_path):
    """A copy of the benchmark with one more cell, added as a workload
    file and a mix file only: the harness finds it by name."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.loads((ROOT / "portbench/mixes/guided_800x600_8spp.json")
                     .read_text())
    mix.update(width=200, height=100)
    (copy / "portbench/mixes/guided_200x100_8spp.json").write_text(
        json.dumps(mix))
    cell = json.loads((ROOT / "portbench/workloads/"
                       "student_guided_800x600.json").read_text())
    cell.update(name="student_guided_200x100", traffic="guided_200x100_8spp")
    (copy / "portbench/workloads/student_guided_200x100.json").write_text(
        json.dumps(cell))
    bench["workloads"].append({k: cell[k] for k in
                               ("name", "config", "traffic", "chips", "why")})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.relative_to(ROOT / "portbench"): p.read_bytes()
              for p in (ROOT / "portbench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    for rel, data in before.items():
        assert (copy / "portbench" / rel).read_bytes() == data
    found = manifest.cell("student_guided_200x100", base=copy / "portbench")
    assert found["mix"]["width"] == 200
    assert found["config_data"]["name"] == "chandelier_student"
    assert not problems(json.loads(
        (copy / "BENCHMARK.json").read_text()))


TOY_KIND = '''"""A toy program kind: a grid of camera rays shaded by one light
drawn from (seed, frame index), in torch; its reference in NumPy."""
import numpy as np
import torch

from portbench.inputs import frame_seed

COLOUR = (1.0, 0.75, 0.5)


def samples_per_frame(cell):
    return cell["mix"]["width"] * cell["mix"]["height"]


def light(seed, index):
    g = torch.Generator().manual_seed(frame_seed(seed, index))
    v = torch.rand(3, generator=g) - torch.tensor([0.5, 0.5, -0.5])
    return v / v.norm()


def shade(d, to_light):
    lam = (d * to_light).sum(-1).clamp_min(0.0)
    return torch.round(255.0 * lam[..., None] * torch.tensor(COLOUR))


class Session:
    def __init__(self, cell, seed, device, trace, tracer=None):
        w, h = cell["mix"]["width"], cell["mix"]["height"]
        y, x = torch.meshgrid(torch.linspace(-1, 1, h),
                              torch.linspace(-1, 1, w), indexing="ij")
        d = torch.stack([x, y, torch.ones_like(x)], -1)
        self.program = d / d.norm(dim=-1, keepdim=True)
        self.seed, self.inputs = seed, None

    def planes(self, index):
        return {"light": light(self.seed, index)}

    def render(self, planes):
        return (shade(self.program, planes["light"]),
                torch.zeros(0, dtype=torch.int64))

    def setup_done(self):
        pass

    def frame_done(self):
        pass

    def run_fields(self):
        return {}

    def close(self):
        self.program = None


class Reference:
    def __init__(self, cell, seed, device, inputs, precision=None,
                 count_work=False):
        self.cell, self.seed = cell, seed

    def frame(self, index):
        w, h = self.cell["mix"]["width"], self.cell["mix"]["height"]
        to_light = light(self.seed, index).numpy().astype(np.float64)
        x, y = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
        d = np.stack([x, y, np.ones_like(x)], -1)
        d /= np.sqrt((d * d).sum(-1, keepdims=True))
        lam = np.maximum((d * to_light).sum(-1), 0.0)
        rgb = np.round(255.0 * lam[..., None] * np.array(COLOUR))
        return (torch.from_numpy(rgb.astype(np.float32)),
                torch.zeros(0, dtype=torch.int64))

    def work_per_frame(self):
        return None
'''

TOY_RUN = '''import json, sys, time
from portbench import harness, manifest
from portbench.programs import toy_grid
bench, cell = manifest.benchmark(), manifest.cell("toy_grid_16x12")
out = []
for broken in (False, True):
    if broken:
        real = toy_grid.shade
        toy_grid.shade = lambda d, to_light: real(d, to_light.flip(0))
    r = harness.run_cell(cell, 2 ** 31 + 5, 0.05, False, device="cpu",
                         t_start=time.perf_counter(), bench=bench,
                         min_frames=3)
    out.append({k: r[k] for k in ("correct", "metrics", "check")})
print(json.dumps(out))
'''


def test_added_program_kind_runs_without_edits(tmp_path):
    """A copy of the benchmark with one more program kind, added as a
    module, a configuration naming it, a mix and a workload only: a whole
    run on the CPU finds it by name, is correct on its counter-less
    frames, and is not correct with its timed path broken."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add = {"programs/toy_grid.py": TOY_KIND,
           "configs/toy_grid.json": json.dumps({
               "name": "toy_grid", "program": "toy_grid",
               "source": "a toy: one light over a grid of camera rays",
               "precision": {"tf32": False}, "reduced": []}),
           "mixes/grid_16x12.json": json.dumps({
               "kind": "frames_closed_loop", "width": 16, "height": 12}),
           "workloads/toy_grid_16x12.json": json.dumps({
               "name": "toy_grid_16x12", "config": "toy_grid",
               "traffic": "grid_16x12", "chips": 1,
               "why": "a toy kind added as files",
               "check": {"frames": 2, "limits": {"pixels_off": 0.02,
                                                 "counters_off": 0.0}}})}
    for rel, text in add.items():
        (copy / "portbench" / rel).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_grid", "source": "a toy",
                             "file": "portbench/configs/toy_grid.json",
                             "reduced": [], "why": "a toy kind"})
    bench["workloads"].append({k: json.loads(add[
        "workloads/toy_grid_16x12.json"])[k] for k in
        ("name", "config", "traffic", "chips", "why")})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    assert not problems(bench)
    for p in (ROOT / "portbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT / "portbench")
            assert (copy / "portbench" / rel).read_bytes() == p.read_bytes()
    proc = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=copy,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    sound, broken = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sound["correct"], sound["check"]
    assert sound["metrics"]["samples_per_s"]["value"] > 0
    assert sound["check"]["counters_off"]["value"] == 0
    assert not broken["correct"], broken["check"]
    assert broken["check"]["pixels_off"]["value"] > 0.5


def test_config_without_a_program_kind_is_refused(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = base / "configs" / "chandelier_student.json"
    cfg = json.loads(path.read_text())
    del cfg["program"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match="program"):
        manifest.cell("student_traditional_800x600", base=base)


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch
    from portbench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "student_traditional_800x600",
                       "--seed", str(2 ** 31 + 7), "--seconds", "1",
                       "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_run_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    the command fails and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "student_traditional_800x600", "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and '"metrics"' not in p.stdout
