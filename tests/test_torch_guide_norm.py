"""The full FB agent's row kernel (raytracer_tpu_torch/core/cuda_norm.py,
csrc/guide_norm.cu) and the f32 guide's forward over it
(raytracer_tpu_torch/fb/fused_guide.py).

On the CPU: ``guide_norm_plain`` equals the module ops at every kind of
site, the fused forward over it equals ``AgentGuide``'s module path bit for
bit on a seeded ``FBConfig()`` agent, and the route (``AgentGuide.fused``)
stays on the modules on CPU tensors, for the bf16 guide, for the learner's
guide with gradients on and at widths the kernel does not take.  On a
card: the kernel against ``guide_norm_plain`` site by site at 160,001 rows
and at 1 and 150, the module-path calls counted, the fused guide against
the module path on a hybrid level's observations, and two frames of the
``fb_agent_hybrid_200x100`` benchmark cell fused against modules.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_guide_norm.py -m cuda
"""
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.cuda_norm import guide_norm, guide_norm_plain
from raytracer_tpu_torch.fb import fused_guide
from raytracer_tpu_torch.fb.agent import FBResearchAgent
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.fb.networks import Dense, LayerNorm
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.utils import profiling

WIDTHS = (512, 256, 128)
SITES = ("ln_relu", "ln_residual", "bias", "bias_relu", "bias_residual")
# The frame the CPU tests take observations from: 256 rays a level.
W, H, SPP, BOUNCES = 16, 8, 2, 3
# The fused guide against the module path on a hybrid level's rows.
CARD_ACTION_GAP = 2e-5

needs_card = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA GPU: run on the card with python -m pytest "
           "--noconftest tests/test_torch_guide_norm.py -m cuda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch on one CPU thread: the suite runs in several xdist workers
    at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(width, seed, in_features=None, device="cpu"):
    """A ``Dense`` into ``width`` and a ``LayerNorm`` over it, every
    parameter drawn (none zero or one), and an input batch."""
    g = torch.Generator().manual_seed(seed)
    dense = Dense(in_features or width, width)
    ln = LayerNorm(width)
    with torch.no_grad():
        dense.kernel.copy_(torch.randn(dense.kernel.shape, generator=g)
                           / np.sqrt(dense.kernel.shape[0]))
        dense.bias.copy_(torch.randn(width, generator=g) * 0.5)
        ln.scale.copy_(1.0 + 0.3 * torch.randn(width, generator=g))
        ln.bias.copy_(0.2 * torch.randn(width, generator=g))
    return dense.to(device), ln.to(device), g


def _site(kind, dense, ln, x, residual):
    """``(module path, (ln, post) for guide_norm)`` of one kind of site."""
    y = dense(x)
    if kind == "ln_relu":
        return torch.relu_(ln(y)), (ln, "relu")
    if kind == "ln_residual":
        return ln(y).add_(residual), (ln, residual)
    if kind == "bias":
        return y, (None, None)
    if kind == "bias_relu":
        return torch.relu_(y), (None, "relu")
    return y.add_(residual), (None, residual)


def _product(x, dense):
    return torch.matmul(x, dense.kernel.reshape(dense.kernel.shape[0], -1))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", SITES)
def test_plain_equals_the_module_ops(kind, width):
    dense, ln, g = _layer(width, seed=width + SITES.index(kind))
    R = 509
    x = torch.randn((R, width), generator=g)
    residual = torch.randn((R, width), generator=g)
    want, (norm_ln, post) = _site(kind, dense, ln, x, residual)
    got = guide_norm_plain(_product(x, dense), dense.bias, norm_ln, post)
    assert torch.equal(got, want)
    # On CPU tensors guide_norm is the plain version, with no launch.
    before = guide_norm.launches
    again = guide_norm(_product(x, dense), dense.bias, norm_ln, post)
    assert torch.equal(again, want) and guide_norm.launches == before


def _perturbed(module, seed):
    """Every Dense bias and LayerNorm parameter moved off flax's initial
    zeros and ones, so the forward's bias and scale reads show."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, LayerNorm):
                m.scale.copy_(1.0 + 0.2 * torch.randn(m.scale.shape,
                                                      generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return module


@pytest.fixture(scope="module")
def agent_and_obs():
    """A seeded agent at ``FBConfig()``'s widths on the chandelier (CPU),
    its biases and LayerNorm parameters perturbed, and 512 observations
    from the guided levels of a small hybrid frame."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    scene, _, _, p = chandelier_scene(device="cpu")
    agent = TrainedFBAgent(None, scene, small_light_indices(scene),
                           p["camera_position"], config=FBConfig(), seed=7,
                           device="cpu")
    _perturbed(agent.encoder, 8)
    _perturbed(agent.backward, 9)
    guide = agent.as_guide_fn()
    rows = []

    def recording(obs):
        rows.append(obs.clone())
        return guide(obs)

    render_path(scene, width=W, height=H, spp=SPP, max_bounces=BOUNCES,
                fov=p["fov"], camera_position=p["camera_position"],
                mirror_threshold=0.9, fb_prob=1.0, guide_fn=recording,
                impl="hybrid", device="cpu",
                generator=torch.Generator().manual_seed(11))
    torch.set_num_threads(n)
    obs = torch.cat(rows)[:512]
    assert obs.shape == (512, 22)
    return agent, obs


def test_fused_forward_equals_the_module_path(agent_and_obs):
    """On CPU tensors the fused forward runs guide_norm_plain at each of
    its sites, and equals the modules bit for bit."""
    agent, obs = agent_and_obs
    before = profiling.counters()["launches.guide_norm"]
    with torch.inference_mode():
        got = fused_guide.action_mean(agent.encoder, agent.backward, obs,
                                      agent.prototype, agent.config.z_dim)
        z = fused_guide.encode(agent.encoder, obs)
    assert profiling.counters()["launches.guide_norm"] == before
    want = agent.as_guide_fn()(obs)
    assert got.dtype == torch.float32 and got.shape == (512, 2)
    assert torch.equal(got, want)
    assert torch.equal(z[:, :agent.config.z_dim], agent.encode(obs))
    # choose_direction: the backward model's mean, clipped.
    np.testing.assert_array_equal(agent.choose_direction(obs.numpy()),
                                  np.clip(got.numpy(), -1.0, 1.0))


def test_route_is_set_when_the_guide_is_built(agent_and_obs):
    """``AgentGuide.fused`` is the one route flag: off for every guide on
    CPU tensors, f32 or bf16, and off for an agent at widths the kernel
    does not take; such calls off the card count no module call."""
    agent, obs = agent_and_obs
    assert not agent.as_guide_fn().fused
    assert not agent.as_guide_fn(torch.bfloat16).fused
    scene, _, _, p = chandelier_scene(device="cpu")
    legacy = TrainedFBAgent(None, scene, small_light_indices(scene),
                            p["camera_position"],
                            config=FBConfig.output6_legacy(), seed=3,
                            device="cpu")
    assert not fused_guide.fits(legacy.encoder, legacy.backward)
    before = profiling.counters()["guide_module_calls"]
    assert legacy.as_guide_fn()(obs[:8]).shape == (8, 2)
    assert profiling.counters()["guide_module_calls"] == before


def test_route_fits_the_kernels_widths_only(agent_and_obs):
    """FBConfig()'s widths fit the kernel; a narrow agent's (the card
    tests' and the recipes' cut-down widths, output6_legacy's 2 * z_dim of
    64) stays on the modules."""
    agent, _ = agent_and_obs
    assert fused_guide.fits(agent.encoder, agent.backward)
    for narrow in (dict(z_dim=8, e_hidden_dim=32, b_hidden_dim=16),
                   dict(z_dim=64, e_hidden_dim=512, b_hidden_dim=64),
                   dict(z_dim=32, e_hidden_dim=256, b_hidden_dim=256)):
        learner = FBResearchAgent(FBConfig(f_hidden_dim=32, **narrow),
                                  seed=1, device="cpu")
        assert not fused_guide.fits(learner.encoder, learner.backward)
        assert not learner.guide().fused


def test_cpu_bf16_and_learner_guides_stay_on_the_modules(agent_and_obs,
                                                         monkeypatch):
    """The f32 and bf16 guides on CPU tensors, and the learner's guide
    called with gradients on (its updates run the modules themselves), never
    reach the fused forward, and launch nothing."""
    agent, obs = agent_and_obs

    def refuse(*args, **kw):
        raise AssertionError("the fused route ran")

    monkeypatch.setattr(fused_guide, "action_mean", refuse)
    before = profiling.counters()["launches.guide_norm"]
    f32 = agent.as_guide_fn()(obs)
    bf16 = agent.as_guide_fn(torch.bfloat16)(obs)
    assert f32.shape == bf16.shape == (512, 2)
    learner = FBResearchAgent(FBConfig(z_dim=8, e_hidden_dim=32,
                                       f_hidden_dim=32, b_hidden_dim=16),
                              seed=1, device="cpu")
    with torch.enable_grad():
        learned = learner.guide()(obs[:64])
    assert learned.shape == (64, 2)
    assert profiling.counters()["launches.guide_norm"] == before


BAD = {
    "three_axes": dict(y=(4, 2, 128)),
    "bias_width": dict(bias=(64,)),
    "ln_width": dict(ln=64),
    "residual_shape": dict(residual=(3, 128)),
    "post_name": dict(post="gelu"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    bad = BAD[case]
    y = torch.zeros(bad.get("y", (4, 128)))
    bias = torch.zeros(bad.get("bias", (128,)))
    ln = LayerNorm(bad["ln"]) if "ln" in bad else None
    post = bad.get("post")
    if "residual" in bad:
        post = torch.zeros(bad["residual"])
    with pytest.raises(ValueError):
        guide_norm(y, bias, ln, post)


def test_counters_name_the_guide_norm_launches():
    c = profiling.counters()
    assert c["launches.guide_norm"] == guide_norm.launches
    assert "guide_module_calls" in c


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", SITES)
def test_kernel_against_plain_on_card(kind, width):
    """Ragged R = 160,001: the kernel equals the plain version bit for bit
    at every site (its row sums add in the order of ATen's reduce), one
    launch a call, in place."""
    dev = torch.device("cuda")
    dense, ln, g = _layer(width, seed=width + SITES.index(kind), device=dev)
    R = 160_001
    x = torch.randn((R, width), generator=g).to(dev)
    residual = torch.randn((R, width), generator=g).to(dev)
    _, (norm_ln, post) = _site(kind, dense, ln, x, residual)
    with torch.inference_mode():
        y = _product(x, dense)
        want = guide_norm_plain(y.clone(), dense.bias, norm_ln, post)
        before = guide_norm.launches
        got = guide_norm(y, dense.bias, norm_ln, post)
        torch.cuda.synchronize()
    assert guide_norm.launches == before + 1
    assert got.data_ptr() == y.data_ptr()
    gap = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    equal = float((got == want).float().mean())
    print(f"{kind} {width}: max rel gap {gap:.3e}, equal {equal:.6f}")
    assert torch.equal(got, want), (kind, width, gap, equal)


# At few rows ATen's reduce may split a row across more than one warp
# (Reduce.cuh's config follows the number of output rows), so the kernel's
# row sums may add in another order than the module path's; everything else
# is the same op in the same order.  The largest relative gap allowed there,
# |kernel - plain| / max(|plain|, 1), and the row counts checked: a single
# observation (choose_direction) and a learner probe's few hundred.  On an
# H100 with PyTorch 2.11 one row read up to 2.4e-7 (widths 512 and 256; 76%
# to 96% of values equal) and 150 rows bit for bit, which the test holds.
SMALL_ROWS_GAP = 1e-5
SMALL_ROWS = (1, 150)
SMALL_ROWS_BIT_EQUAL = (150,)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ("ln_relu", "ln_residual"))
@pytest.mark.parametrize("rows", SMALL_ROWS)
def test_kernel_against_plain_at_few_rows_on_card(rows, kind, width):
    """The LayerNorm sites at R = 1 and 150, where the learner's walk and
    probe call the guide: within SMALL_ROWS_GAP of the plain version, and
    bit for bit at SMALL_ROWS_BIT_EQUAL, so a change of ATen's order shows
    here by name."""
    dev = torch.device("cuda")
    dense, ln, g = _layer(width, seed=rows + width + len(kind), device=dev)
    x = torch.randn((rows, width), generator=g).to(dev)
    residual = torch.randn((rows, width), generator=g).to(dev)
    _, (norm_ln, post) = _site(kind, dense, ln, x, residual)
    with torch.inference_mode():
        y = _product(x, dense)
        want = guide_norm_plain(y.clone(), dense.bias, norm_ln, post)
        got = guide_norm(y, dense.bias, norm_ln, post)
        torch.cuda.synchronize()
    gap = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    equal = float((got == want).float().mean())
    print(f"{kind} {width} at {rows} rows: max rel gap {gap:.3e}, equal "
          f"{equal:.6f}, bit equal {bool(torch.equal(got, want))}")
    assert gap <= SMALL_ROWS_GAP, (rows, kind, width, gap, equal)
    if rows in SMALL_ROWS_BIT_EQUAL:
        assert torch.equal(got, want), (rows, kind, width, gap, equal)


@pytest.mark.cuda
@needs_card
def test_guides_off_the_kernel_count_module_calls_on_card():
    """On the card an agent at widths the kernel does not take
    (output6_legacy: 2 * z_dim = 64) and the bf16 guide run the modules:
    no launch, one guide_module_calls a call."""
    dev = torch.device("cuda")
    scene, _, _, p = chandelier_scene(device=dev)
    legacy = TrainedFBAgent(None, scene, small_light_indices(scene),
                            p["camera_position"],
                            config=FBConfig.output6_legacy(), seed=3,
                            device=dev)
    obs = torch.rand((300, 22), device=dev,
                     generator=torch.Generator(dev).manual_seed(4))
    before = profiling.counters()
    for guide in (legacy.as_guide_fn(), legacy.as_guide_fn(torch.bfloat16)):
        assert not guide.fused
        assert guide(obs).shape == (300, 2)
    after = profiling.counters()
    assert after["launches.guide_norm"] == before["launches.guide_norm"]
    assert after["guide_module_calls"] == before["guide_module_calls"] + 2


def _hybrid_agent(dev):
    scene, _, _, p = chandelier_scene(device=dev)
    agent = TrainedFBAgent(None, scene, small_light_indices(scene),
                           p["camera_position"], config=FBConfig(), seed=0,
                           device=dev)
    return scene, p, agent


@pytest.mark.cuda
@needs_card
def test_fused_guide_against_modules_on_a_hybrid_level_on_card():
    """160,000 observations of a 200x100@8spp hybrid level, the seeded
    FBConfig() agent: fused actions within CARD_ACTION_GAP of the module
    path's, 16 launches a call."""
    dev = torch.device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    scene, p, agent = _hybrid_agent(dev)
    guide = agent.as_guide_fn()
    rows = []

    def recording(obs):
        rows.append(obs.clone())
        return guide(obs)

    render_path(scene, width=200, height=100, spp=8, max_bounces=8,
                fov=p["fov"], camera_position=p["camera_position"],
                mirror_threshold=0.9, fb_prob=1.0, guide_fn=recording,
                impl="hybrid", device=dev,
                generator=torch.Generator(dev).manual_seed(2_400_000_017))
    obs = rows[1]
    assert obs.shape == (160_000, 22)
    before = guide_norm.launches
    fused = guide(obs)
    torch.cuda.synchronize()
    assert guide_norm.launches == before + 16
    calls = profiling.counters()["guide_module_calls"]
    guide.fused = False
    modules = guide(obs)
    torch.cuda.synchronize()
    assert guide_norm.launches == before + 16
    assert profiling.counters()["guide_module_calls"] == calls + 1
    gap = float((fused - modules).abs().max())
    equal = float((fused == modules).all(-1).float().mean())
    print(f"actions: max abs gap {gap:.3e}, rows equal {equal:.6f}")
    assert gap <= CARD_ACTION_GAP


@pytest.mark.cuda
@needs_card
def test_hybrid_cell_frames_fused_against_modules_on_card():
    """Two frames of the fb_agent_hybrid_200x100 benchmark cell (its
    seeded agent, planes and draws from seed 3,000,000,019): the fused
    guide's frames against the module path's within the cell's limits
    (pixels_off 0.015, counters_off 2e-4), 128 launches a frame."""
    from portbench import check, manifest
    from portbench.harness import Session
    dev = torch.device("cuda")
    cell = manifest.cell("fb_agent_hybrid_200x100")
    torch.backends.cuda.matmul.allow_tf32 = cell["config_data"][
        "precision"]["tf32"]
    session = Session(cell, 3_000_000_019, dev, trace=False)
    try:
        fused, launches = [], []
        for i in range(2):
            before = guide_norm.launches
            fused.append(session.render(session.planes(i)))
            launches.append(guide_norm.launches - before)
        assert session.program.guide.fused
        session.program.guide.fused = False
        modules = [session.render(session.planes(i)) for i in range(2)]
    finally:
        session.close()
    pairs = [(fi, fc, mi, mc) for (fi, fc), (mi, mc) in zip(fused, modules)]
    values = check.numbers(pairs)
    print(f"fused against modules: {values}, launches {launches}")
    assert launches == [128, 128]
    assert check.judge(values, cell["check"]["limits"]), values
