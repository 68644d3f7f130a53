"""Whole runs on the CPU at small sizes (the look for a card skipped), with
the timed path broken underneath: ``correct`` turns false for each fault
a cell can have, and stays true without one.  And the control, the
reference at the precision below the configuration's in the program's
place, fails the cell's limits.  (One card a cell: no exchange between
cards to leave out.)"""
import functools
import time

import pytest
import torch

from portbench import check, harness, manifest
from portbench.tools.readings import readings

BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 32 + 17


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(name):
    cell = manifest.cell(name)
    cell["mix"].update(width=24, height=18, spp=2)
    cell["check"]["frames"] = 2
    return cell


def run(cell):
    return harness.run_cell(cell, SEED, 0.05, False, device="cpu",
                            t_start=time.perf_counter(), bench=BENCH,
                            min_frames=3)


def stale(real):
    """A step that returns its state unchanged: every frame the first."""
    first = []

    @functools.wraps(real)
    def render_path(scene, **kw):
        if not first:
            first.append(real(scene, **kw))
        return first[0]
    return render_path


def half(real):
    """Half of the samples left out, the mean taken over the rest."""
    @functools.wraps(real)
    def render_path(scene, *, jitter, uniforms=None, fb_uniforms=None,
                    spp, **kw):
        h = spp // 2
        rays = h * jitter.shape[1] * jitter.shape[2]
        cut = (lambda p: None if p is None else p[:, :rays].contiguous())
        return real(scene, jitter=jitter[:h], uniforms=cut(uniforms),
                    fb_uniforms=cut(fb_uniforms), spp=h, **kw)
    return render_path


def altered(real):
    """Every seventh sample's red one unit brighter where the trace
    produces it."""
    @functools.wraps(real)
    def trace_path(*args, **kw):
        rgb, stats = real(*args, **kw)
        rgb = rgb.clone()
        rgb[::7, 0] += 1.0
        return rgb, stats
    return trace_path


FAULTS = {"stale": ("render_path", stale), "half": ("render_path", half),
          "altered": ("trace_path", altered)}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run(small(name))
    assert result["correct"], result["check"]
    assert result["attempted"] >= 3
    assert set(result["metrics"]) == {
        m["name"] for m in manifest.metrics_for(BENCH, name, "end_to_end")}
    assert list(result)[-2:] == ["check", "lines"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    from raytracer_tpu_torch.render import path_renderer
    attr, make = FAULTS[fault]
    monkeypatch.setattr(path_renderer, attr,
                        make(getattr(path_renderer, attr)))
    result = run(small(name))
    assert not result["correct"], (fault, result["check"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small(name)
    cell["mix"].update(width=40, height=30)
    r = readings(cell, SEED, 0.05, control=True, device="cpu")
    limits = cell["check"]["limits"]
    assert check.judge(r["program"], limits), r
    assert not check.judge(r["control"], limits), r
