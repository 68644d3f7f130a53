"""The frozen reference against the port's plain routes on the CPU, at
tiny shapes, for each of the four traffics; its work counters against
the port's ``tools/level_edges.py::level_work`` on a seeded case."""
import pytest
import torch

from portbench import inputs, manifest
from portbench.programs.render_path import Program, Reference
from portbench.reference import plain, work

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name, width=12, height=9, spp=2):
    cell = manifest.cell(name)
    cell["mix"].update(width=width, height=height, spp=spp)
    return cell


def program_frame(cell, planes, impl, params):
    prog = Program(cell, SEED, "cpu", params)
    prog.kw["impl"] = impl
    return prog.render(planes)


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_port(name):
    cell = tiny(name)
    mix = cell["mix"]
    params = None
    if mix["guided"] and cell["config_data"]["guide"]["kind"] == "fb_agent":
        params = inputs.agent_params(SEED, cell["config_data"]["guide"],
                                     "cpu")
    ref = Reference(cell, SEED, "cpu", params)
    impls = {mix["impl"]}
    if mix.get("guide_max_level") is None:
        impls.add("plain")
    for index in (0, 5):
        planes = ref.planes(index)
        ref_image, ref_counters = ref.frame(index)
        for impl in sorted(impls):
            image, counters = program_frame(cell, planes, impl, params)
            assert torch.equal(image, ref_image), impl
            assert torch.equal(counters, ref_counters), impl
        if mix["guided"]:
            assert int(ref_counters[4]) > 0       # the guide steered rays


def test_counters_are_the_frame_totals():
    cell = tiny("student_guided_800x600")
    ref = Reference(cell, SEED, "cpu")
    _, counters = ref.frame(0)
    mix = cell["mix"]
    rays = mix["width"] * mix["height"] * mix["spp"]
    assert int(counters[0]) >= rays            # every camera ray runs
    assert int(counters[2]) >= int(counters[3])
    assert int(counters[5]) <= int(counters[4])


def test_planes_repeat_from_seed_and_index():
    cell = tiny("fb_agent_hybrid_200x100")
    ref = Reference(cell, SEED, "cpu",
                    inputs.agent_params(SEED, cell["config_data"]["guide"],
                                        "cpu"))
    a, b, c = ref.planes(3), ref.planes(3), ref.planes(4)
    assert set(a) == {"jitter", "uniforms", "fb_uniforms"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["jitter"], c["jitter"])
    trad = Reference(tiny("student_traditional_800x600"), SEED, "cpu")
    assert set(trad.planes(0)) == {"jitter"}


def test_large_seeds():
    assert inputs.frame_seed(2 ** 40 + 3, 0) < 2 ** 62
    assert inputs.frame_seed(5, 0) != inputs.frame_seed(5, 1)


@pytest.mark.parametrize("threshold,seed", [(0.9, 3), (0.0, 4)])
def test_work_equals_level_work(threshold, seed):
    """The frozen counters count what the port's ``level_work`` counts,
    level by level, on seeded rays across the level's rewrites."""
    from raytracer_tpu_torch.core import cuda_path
    from raytracer_tpu_torch.tools import level_edges
    from raytracer_tpu_torch.trace.path import emissive_indices, scene_spec
    scene, o, d = level_edges.edge_scene(seed, 2000, device="cpu")
    spec = scene_spec(scene)
    table = cuda_path.path_table(spec, emissive_indices(scene), threshold,
                                 "cpu")
    rows = [plain.Sphere(*row) for row in spec]
    g = torch.Generator().manual_seed(seed)
    L = 4
    u = torch.rand((L, o.shape[0], 2), generator=g)
    if plain.no_diffuse_possible(rows, threshold):
        u = None
    mine = work.Work(rows)
    theirs = {}

    def counted(lo, ld, lrun, lu, ltable, **kw):
        lv = cuda_path.level_plain(lo, ld, lrun, lu, ltable,
                                   fast=kw["fast"], want_hit=True)
        for k, v in level_edges.level_work(lo, ld, lrun, lu, ltable,
                                           lv).items():
            if not isinstance(v, dict):
                theirs[k] = theirs.get(k, 0) + v
        return lv

    rgb_p, counts_p = cuda_path.trace_levels(
        counted, o, d, u, table, max_bounces=L, background=(2.0, 2.0, 5.0))
    rgb_r, counts_r = plain.trace(o, d, rows, max_bounces=L,
                                  mirror_threshold=threshold,
                                  background=(2.0, 2.0, 5.0), uniforms=u,
                                  on_level=mine)
    assert torch.equal(rgb_p, rgb_r)
    assert torch.equal(counts_p, counts_r[:, :4])
    for k, v in theirs.items():
        assert mine.totals[k] == v, k
    assert mine.totals["levels"] == L
    assert mine.totals["valid_sphere_tests"] > 0
    assert mine.totals["lights_computed"] > 0
    assert work.level_ops(mine.totals) > 0
