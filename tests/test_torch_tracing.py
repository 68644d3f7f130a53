"""The frame path's spans and counters (``utils/profiling.py``): under a
``torch.profiler`` session each route of ``render_path`` records its
spans, nested as the frame runs them; without one ``span`` records
nothing; ``host_reads`` and ``guide_rows`` count the work of each call;
the image and counters are the same with tracing on and off.  Small
frames of the chandelier scene on the CPU, where the kernel, hybrid and
stepwise routes run their plain versions."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from raytracer_tpu_torch.core import (cuda_intersect, cuda_level, cuda_path,
                                      cuda_whitted)
from raytracer_tpu_torch.fb.distill import StudentGuide
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.utils import profiling

from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H, SPP, BOUNCES = 16, 8, 2, 3
R = W * H * SPP
CALLER = "caller.frame"
SPAN = "raytracer."

# (impl, guide_max_level, mirror_threshold, spp_chunk): host reads a
# render_path call, levels that run the guide.
CASES = {
    "kernel": (("kernel", None, 0.9, None), 12, BOUNCES),
    "plain": (("plain", None, 0.9, None), 12, BOUNCES),
    "hybrid": (("hybrid", None, 0.9, None), 12, BOUNCES),
    "stepwise": (("stepwise", None, 0.9, None), 20, BOUNCES),
    "stepwise_gml2": (("stepwise", 2, 0.9, None), 20, 2),
    "traditional": (("kernel", None, 0.0, None), 12, 0),
    "chunked": (("kernel", None, 0.9, 1), 24, 2 * BOUNCES),
}


@pytest.fixture(scope="module")
def scene():
    return chandelier_scene(device="cpu")


def student():
    g = torch.Generator().manual_seed(7)
    layers = [(torch.randn(22, 8, generator=g) * 0.3, torch.zeros(8)),
              (torch.randn(8, 2, generator=g) * 0.3, torch.zeros(2))]
    return StudentGuide(layers, None)


def frame(scene, case):
    impl, gml, mirror, chunk = case
    sc, _, _, p = scene
    return render_path(sc, width=W, height=H, spp=SPP, max_bounces=BOUNCES,
                       fov=p["fov"], camera_position=p["camera_position"],
                       mirror_threshold=mirror, guide_fn=student(),
                       fb_prob=1.0, impl=impl, guide_max_level=gml,
                       spp_chunk=chunk, device="cpu",
                       generator=torch.Generator().manual_seed(3))


def traced(scene, case):
    """The frame under a CPU profiler, inside the caller's span: its
    output and its spans as ``(name, start, end)``, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = frame(scene, case)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(SPAN) or e.name() == CALLER)
    return out, [(n, s, e) for s, e, n in spans]


def parents(spans):
    """Each span with the name of the innermost span enclosing it."""
    out = []
    for i, (n, s, e) in enumerate(spans):
        around = [(e2 - s2, n2) for j, (n2, s2, e2) in enumerate(spans)
                  if j != i and s2 <= s and e <= e2]
        out.append((n, min(around)[1] if around else None))
    return out


@pytest.mark.parametrize("name", CASES)
def test_spans_nest_as_the_frame_runs(scene, name):
    case, _, guided_levels = CASES[name]
    chunks = SPP // case[3] if case[3] else 1
    _, spans = traced(scene, case)
    tree = parents(spans)
    names = [n for n, _ in tree]
    assert names[0] == CALLER and names.count(CALLER) == 1
    # The frame is one span under the caller's, the others inside it.
    assert [n for n, p in tree if p == CALLER] == ["raytracer.render"]
    top = [n for n, p in tree if p == "raytracer.render"]
    # On CPU tensors every route traces level by level (the kernel route
    # runs its plain version): no path kernel span.
    assert "raytracer.path_kernel" not in names
    assert top.count("raytracer.render_setup") == 1
    assert top.count("raytracer.camera") == chunks
    assert top.count("raytracer.trace_setup") == chunks
    assert top.count("raytracer.level") == chunks * BOUNCES
    # trace_levels' fold, then trace_path's PathStats; the spp sums and the
    # average (with a chunked render's PathStats sum).
    assert top.count("raytracer.fold") == 2 * chunks
    assert top.count("raytracer.image") == chunks + 1
    assert len(top) == len(tree) - 2 - names.count("raytracer.level_step") \
        - names.count("raytracer.guide")
    # Each level: one level step, and the guide on the guided levels only.
    levels = [i for i, n in enumerate(names) if n == "raytracer.level"]
    guided = 0
    for k, i in enumerate(levels):
        lo, hi = spans[i][1], spans[i][2]
        inside = [n for n, s, e in spans if lo <= s and e <= hi
                  and n != "raytracer.level"]
        assert inside.count("raytracer.level_step") == 1
        want_guide = k % BOUNCES < (guided_levels // chunks)
        assert inside.count("raytracer.guide") == int(want_guide)
        assert set(inside) <= {"raytracer.level_step", "raytracer.guide"}
        guided += want_guide
    assert guided == guided_levels
    assert dict(tree)["raytracer.level_step"] == "raytracer.level"


@pytest.mark.parametrize("name", CASES)
def test_counters_count_each_call(scene, name):
    case, reads, guided_levels = CASES[name]
    before = profiling.counters()
    frame(scene, case)
    frame(scene, case)
    after = profiling.counters()
    delta = {k: after[k] - before[k] for k in after}
    assert delta["host_reads"] == 2 * reads
    assert delta["guide_rows"] == 2 * guided_levels * R // (
        SPP // case[3] if case[3] else 1)
    assert all(v == 0 for k, v in delta.items() if k.startswith("launches"))


@pytest.mark.parametrize("name", ["kernel", "stepwise_gml2", "chunked"])
def test_tracing_changes_no_output(scene, name):
    case = CASES[name][0]
    image, stats = frame(scene, case)
    (image_t, stats_t), spans = traced(scene, case)
    assert len(spans) > 1
    assert torch.equal(image, image_t)
    assert stats.as_dict() == stats_t.as_dict()


def test_span_off_records_nothing():
    off = profiling.span("raytracer.camera")
    assert off is profiling.span("raytracer.level")
    with off:
        with off:
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.span("raytracer.camera")
        with on:
            torch.ones(2).sum()
    assert on is not off
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("raytracer.camera") == 1
    assert profiling.span("raytracer.camera") is off


def test_counters_name_the_launch_counts():
    c = profiling.counters()
    assert c["launches.path_trace"] == cuda_path.path_trace.launches
    for route, n in cuda_path.path_trace.route_launches.items():
        assert c[f"launches.path_trace.{route}"] == n
    assert c["launches.path_level"] == cuda_level.path_level.launches
    assert c["launches.nearest_hit"] == cuda_intersect.nearest_hit.launches
    assert c["launches.whitted_trace"] == cuda_whitted.whitted_trace.launches
    assert {"host_reads", "guide_rows"} <= set(c)
