"""The statistics on synthetic records: a planted stall moves both
end-to-end metrics (every frame of the window counts, no median of
chunks), and the idle share takes the union of overlapping kernels."""
import pytest

from portbench import stats, tracing
from portbench.harness import Run
from portbench.metrics import (device_idle_share, frame_ms_p95,
                               samples_per_s)


def run_of(durations, samples=1000):
    frames, t = [], 100.0
    for d in durations:
        frames.append((t, t + d))
        t += d
    return Run(config={}, mix={}, diffuse=False,
               samples_per_frame=samples, setup_s=1.0, window_start=100.0,
               frames=frames)


def test_rate_and_tail_over_every_frame():
    steady = run_of([0.010] * 400)
    assert samples_per_s.read(steady) == pytest.approx(1000 / 0.010)
    assert frame_ms_p95.read(steady) == pytest.approx(10.0)


@pytest.mark.parametrize("stalls", [1, 25])
def test_a_stall_lowers_the_rate_and_raises_the_tail(stalls):
    base = run_of([0.010] * 400)
    durations = [0.010] * 400
    for i in range(stalls):
        durations[7 + 13 * i] = 0.5
    stalled = run_of(durations)
    assert samples_per_s.read(stalled) < samples_per_s.read(base)
    if stalls >= 21:          # more than 5% of the frames
        assert frame_ms_p95.read(stalled) > frame_ms_p95.read(base)
    else:
        assert frame_ms_p95.read(stalled) >= frame_ms_p95.read(base)


def test_rate_counts_the_window_to_its_last_frame():
    r = run_of([0.010] * 10)
    r.window_start = 99.0          # the window opened 1 s before frame 0
    assert samples_per_s.read(r) == pytest.approx(10 * 1000 / 1.1)


def test_percentile_interpolates():
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_union_merges_overlaps():
    assert stats.union([(0, 10), (5, 20), (30, 40), (40, 41)]) == [
        (0, 20), (30, 41)]
    assert stats.gaps([(0, 20), (30, 41)], 0, 50) == [(20, 30), (41, 50)]


def events(kernels, frame=(0, 1000)):
    ev = [("portbench.frame", False, *frame),
          ("portbench.render", False, 0, 900),
          ("aten::nonzero", False, 400, 600)]
    return ev + [(n, True, s, e) for n, s, e in kernels]


def test_idle_share_takes_the_union():
    """Two kernels overlapping on two streams are busy once."""
    rec = tracing.reduce(events([("a", 0, 600), ("b", 100, 500),
                                 ("c", 800, 900)]), frames=1)
    assert rec.busy_s == pytest.approx(700e-9)
    assert rec.window_s == pytest.approx(1000e-9)
    r = run_of([0.01])
    r.trace = rec
    assert device_idle_share.read(r) == pytest.approx(30.0)
    # Summed durations would give 0.4 s more and a lower idle share.
    assert sum(rec.kernel_s.values()) == pytest.approx(1100e-9)


def test_mirrored_spans_are_not_device_work():
    ev = events([("a", 0, 100)]) + [("portbench.render", True, 0, 900)]
    rec = tracing.reduce(ev, frames=1)
    assert rec.busy_s == pytest.approx(100e-9)
    assert "portbench.render" not in rec.kernel_s


def test_gaps_are_named_by_the_host():
    rec = tracing.reduce(events([("a", 0, 400), ("b", 600, 1000)]),
                         frames=1)
    assert rec.gaps == [("portbench.render/aten::nonzero",
                         pytest.approx(200e-9))]
    assert rec.breakdown()["device_ops"][0][0] in ("a", "b")


def test_no_frame_or_no_device_reads_nothing():
    assert tracing.reduce([("aten::mm", False, 0, 10)], 1) is None
    assert tracing.reduce(events([]), 1) is None
    r = run_of([0.01])
    assert device_idle_share.read(r) is None
