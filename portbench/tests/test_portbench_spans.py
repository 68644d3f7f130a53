"""The record read with the program's spans (``spans.reduce``) on synthetic
event lists: on events without program spans it is ``tracing.reduce``'s
record; the program's spans and their device mirrors move none of its
window, busy or device times; gap names come in three parts; each span
name's idle seconds are the exact overlap; and the readers of the spans
and counters read nothing where the record lacks them."""
import pytest

from portbench import spans, tracing
from portbench.harness import Run
from portbench.metrics import (device_idle_share, frame_mfu,
                               guide_steered_share, host_reads_per_frame,
                               level_step_idle_share, trace_setup_idle_share)


def harness_events():
    """Two frames as the harness traces them, without program spans:
    frame, draw, render spans, host ops, kernels on two streams."""
    ev = []
    for t in (0, 10_000):
        ev += [("portbench.frame", False, t, t + 9_000),
               ("portbench.draw", False, t, t + 1_000),
               ("portbench.render", False, t + 1_000, t + 9_000),
               ("aten::_to_copy", False, t + 1_900, t + 2_200),
               ("aten::sum", False, t + 7_000, t + 7_100),
               ("cudaLaunchKernel", False, t + 3_000, t + 3_100),
               ("aten::mul", False, t + 6_000, t + 6_200),
               ("uniform_kernel", True, t + 100, t + 900),
               ("path_trace_kernel", True, t + 3_200, t + 5_800),
               ("copy_kernel", True, t + 5_000, t + 6_100),
               ("Memcpy DtoH", True, t + 8_000, t + 8_800),
               ("portbench.render", True, t + 3_200, t + 8_800)]
    return ev


def program_spans():
    """The program's spans in each frame (host), and the device mirror
    the profiler may make of each."""
    ev = []
    for t in (0, 10_000):
        host = [("raytracer.camera", t + 1_000, t + 1_150),
                ("raytracer.trace_setup", t + 1_150, t + 3_000),
                ("raytracer.path_kernel", t + 3_000, t + 3_150),
                ("raytracer.fold", t + 5_900, t + 6_400),
                ("raytracer.image", t + 6_400, t + 7_900)]
        ev += [(n, False, s, e) for n, s, e in host]
        ev += [("raytracer.path_kernel", True, t + 3_200, t + 5_800),
               ("raytracer.fold", True, t + 6_000, t + 7_950)]
    return ev


def test_without_program_spans_the_record_is_tracing_reduce():
    ev = harness_events()
    old, new = tracing.reduce(ev, 2), spans.reduce(ev, 2)
    assert (new.window_s, new.busy_s, new.frames) == (
        old.window_s, old.busy_s, old.frames)
    assert new.kernel_s == old.kernel_s
    assert new.gaps == old.gaps
    assert new.span_idle_s == {} and new.counters is None
    assert new.breakdown() == old.breakdown()


def test_program_spans_and_mirrors_move_no_device_time():
    ev = harness_events()
    old = tracing.reduce(ev, 2)
    new = spans.reduce(ev + program_spans(), 2)
    assert new.window_s == old.window_s
    assert new.busy_s == pytest.approx(old.busy_s)
    assert new.kernel_s == old.kernel_s
    assert [s for _, s in new.gaps] == [s for _, s in old.gaps]
    # Read by tracing.reduce, the mirrors would be device work.
    assert tracing.reduce(ev + program_spans(), 2).busy_s > old.busy_s
    for reader in (device_idle_share, frame_mfu):
        r_old, r_new = run_of(old), run_of(new)
        r_old.work = r_new.work = None
        assert reader.read(r_new) == reader.read(r_old)


def test_gap_names_carry_the_program_span():
    new = spans.reduce(harness_events() + program_spans(), 2)
    old = tracing.reduce(harness_events(), 2)
    # The first frame's draw, set-up, image, the host between frames, the
    # second frame's set-up and image, the end of its render.
    names = ["portbench.draw",
             "portbench.render/raytracer.trace_setup/aten::_to_copy",
             "portbench.render/raytracer.image/aten::sum",
             "portbench.host",
             "portbench.render/raytracer.trace_setup/aten::_to_copy",
             "portbench.render/raytracer.image/aten::sum",
             "portbench.render"]
    assert [n for n, _ in new.gaps] == names
    assert [n for n, _ in old.gaps] == [
        n.replace("raytracer.trace_setup/", "").replace(
            "raytracer.image/", "") for n in names]


def test_idle_seconds_by_span_name_are_exact():
    # Device busy [0, 100], [300, 400], [700, 1000]; the window [0, 1000].
    # "a" twice, overlapping, [50, 350] and [200, 800]: its union [50, 800]
    # meets the gaps [100, 300] and [400, 700]: 500 ns.  "b" nested in "a"
    # at [150, 420]: 150 + 20.  "d" meets no gap: 0.  "c" outside the window
    # reads nothing.
    ev = [("portbench.frame", False, 0, 1000),
          ("k", True, 0, 100), ("k", True, 300, 400), ("k", True, 700, 1000),
          ("raytracer.a", False, 50, 350), ("raytracer.a", False, 200, 800),
          ("raytracer.b", False, 150, 420),
          ("raytracer.d", False, 0, 100),
          ("raytracer.c", False, 2000, 3000)]
    rec = spans.reduce(ev, 1)
    assert rec.span_idle_s == pytest.approx(
        {"raytracer.a": 500e-9, "raytracer.b": 170e-9, "raytracer.d": 0.0})
    assert sum(s for _, s in rec.gaps) == pytest.approx(500e-9)
    # The middle of [100, 300] is in "a" and "b": the shorter names it.
    assert [n for n, _ in rec.gaps] == ["portbench.frame/raytracer.b",
                                        "portbench.frame/raytracer.a"]


def test_overlap_of_interval_lists():
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0


def run_of(trace, work=None):
    return Run(config={}, mix={}, diffuse=False, samples_per_frame=1,
               setup_s=1.0, frames=[(0.0, 1.0)], trace=trace, work=work)


def record(span_idle_s=None, counters=None):
    return spans.SpanRecord(1.0, 0.5, 4, {}, [], span_idle_s=span_idle_s
                            or {}, counters=counters)


def test_readers_of_spans_and_counters():
    rec = record({"raytracer.trace_setup": 0.2, "raytracer.level_step": 0},
                 {"host_reads": 48, "guide_rows": 4_000})
    r = run_of(rec, work={"guided_rows": 250.0})
    assert trace_setup_idle_share.read(r) == pytest.approx(20.0)
    assert level_step_idle_share.read(r) == 0.0
    assert host_reads_per_frame.read(r) == 12.0
    assert guide_steered_share.read(r) == pytest.approx(25.0)


@pytest.mark.parametrize("trace", [
    None,
    tracing.TraceRecord(1.0, 0.5, 4, {}, []),
    record(),
    record({"raytracer.camera": 0.1}, {"launches.path_trace": 4}),
    record(counters={"host_reads": 0, "guide_rows": 0}),
], ids=["no_trace", "tracing_record", "empty", "other_names", "zero_rows"])
def test_readers_read_nothing_where_input_is_absent(trace):
    r = run_of(trace, work={"guided_rows": 250.0})
    assert trace_setup_idle_share.read(r) is None
    assert level_step_idle_share.read(r) is None
    assert guide_steered_share.read(r) is None
    if trace is None or getattr(trace, "counters", None) is None or \
            "host_reads" not in trace.counters:
        assert host_reads_per_frame.read(r) is None
    assert guide_steered_share.read(run_of(
        record(counters={"guide_rows": 8}), work=None)) is None


def test_span_tracer_takes_the_counters_around_the_traced_frames():
    ticks = iter(range(100))

    class T(spans.SpanTracer):
        counters = staticmethod(lambda: {"host_reads": 12 * next(ticks)})

    t = T(seconds=1.0, at=0.0, target_s=0.0)
    t.before_frame(0.5, 0.1)            # starts the profiler: 0 reads
    for _ in range(2):
        t.after_frame()                 # two frames, then it stops: 12
    assert t.done and t.traced == 2
    assert t.deltas == {"host_reads": 12}
    assert t.record() is None           # no device activity on the CPU
    plain = spans.SpanTracer(seconds=1.0, at=0.0, target_s=0.0)
    plain.before_frame(0.5, 0.1)
    plain.finish()
    assert plain.deltas is None
