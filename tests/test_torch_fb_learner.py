"""The FB learner in the port (raytracer_tpu_torch/fb/agent.py,
utils/checkpoint.py's writing side) held against raytracer_tpu/fb/agent.py.

Both agents start from one checkpoint (JAX's initial parameters at a
narrow config, written by JAX's ``save_fb``), so their parameters, their
fresh Adam states and their ``default_rng(seed)`` replay draws agree.

* The replay buffer's batches are equal (numpy in both).
* The loss terms within ``LOSS_TOL`` relative (f32 products summed in
  another order; measured 5e-7), and every parameter after 1 and after 5
  Adam steps within ``PARAM_TOL`` absolute (measured 3.6e-7; the learning
  rate is 2e-4, so that is well under one step).
* ``record_success``: the update count from the records crossed (capped at
  64 a call), the noise decay, the light memory (last 20 latents) and the
  target encoder's refresh, as JAX's.
* ``save_fb`` both ways: a port checkpoint read by JAX's ``load_fb`` and a
  JAX one by the port's, every parameter bit for bit.
"""
import contextlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.agent import FBResearchAgent as JaxAgent
from raytracer_tpu.fb.agent import ReplayBuffer as JaxBuffer
from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.utils.checkpoint import _flatten
from raytracer_tpu.utils.checkpoint import load_fb as jax_load_fb
from raytracer_tpu_torch.fb.agent import FBResearchAgent, ReplayBuffer
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.utils.checkpoint import (PARTS, flat_params,
                                                  load_fb, save_fb)

from test_torch_fb_networks import NARROW

CFG = dict(NARROW, batch_size=32, buffer_capacity=2000, update_freq=16,
           target_update_freq=48)


@contextlib.contextmanager
def hidden_loader_stub():
    """Hide the stub module ``fb_ray_tracing`` that the JAX package's
    ``utils/torch_import.py::load_torch_checkpoint`` leaves in
    ``sys.modules`` (tests/test_fb.py runs it earlier in the same xdist
    worker; ROADMAP, known gaps of the reference): building
    ``torch.optim.Adam`` may import ``torch.distributed``, whose operator
    registration walks ``sys.modules`` with ``inspect`` and fails on the
    stub's ``__file__``.  Put back after."""
    stub = sys.modules.pop("fb_ray_tracing", None)
    try:
        yield
    finally:
        if stub is not None:
            sys.modules["fb_ray_tracing"] = stub


@pytest.fixture(autouse=True)
def without_leaked_loader_stub():
    with hidden_loader_stub():
        yield


LOSS_TOL = 1e-5
PARAM_TOL = 1e-5


def jax_flat(params, parts=("encoder", "forward", "backward")):
    out = {}
    for part in parts:
        out.update({f"{part}::{k}": np.asarray(v) for k, v in
                    _flatten(getattr(params, part)).items()})
    return out


def port_flat(agent, parts=("encoder", "forward", "backward")):
    out = {}
    for part in parts:
        out.update(flat_params(agent.nets[part], f"{part}::"))
    return out


@pytest.fixture()
def pair(tmp_path):
    """A JAX agent and a port agent on the same initial parameters."""
    ja = JaxAgent(JaxConfig(**CFG), seed=0)
    path = tmp_path / "init.npz"
    ja.save(path)
    ta = FBResearchAgent(FBConfig(**CFG), seed=0, device="cpu")
    ta.load(path)
    return ja, ta


def _transitions(n, seed, hit_rate=0.2):
    rng = np.random.RandomState(seed)
    obs = rng.randn(n, 22).astype(np.float32)
    obs[:, :3] *= 5
    act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    nxt = rng.randn(n, 22).astype(np.float32)
    hit = (rng.rand(n) < hit_rate).astype(np.float32)
    return obs, act, nxt, hit.copy(), hit


def test_replay_batches_equal():
    jb, tb = JaxBuffer(100, 22, 2), ReplayBuffer(100, 22, 2)
    for seed, n in ((1, 60), (2, 70), (3, 5)):     # wraps around
        for b in (jb, tb):
            b.add(*_transitions(n, seed))
    assert (jb.size, jb.pos) == (tb.size, tb.pos) == (100, 35)
    for frac in (0.25, 0.0):
        want = jb.sample(np.random.default_rng(7), 32, frac)
        got = tb.sample(np.random.default_rng(7), 32, frac)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_loss_and_adam_steps_match_jax(pair):
    ja, ta = pair
    for step in range(5):
        batch = _transitions(32, 10 + step)
        ja.params, ja.opt_state, total, aux = ja._update_step(
            ja.params, ja.opt_state, tuple(jnp.asarray(b) for b in batch))
        got_total, terms = ta.update(batch)
        assert abs(got_total - float(total)) <= LOSS_TOL * abs(float(total))
        for k, v in aux.items():
            assert abs(terms[k] - float(v)) <= LOSS_TOL * max(abs(float(v)),
                                                              1e-3), k
        if step in (0, 4):
            want, got = jax_flat(ja.params), port_flat(ta)
            assert set(want) == set(got)
            for k in want:
                err = np.abs(got[k] - want[k]).max()
                assert err <= PARAM_TOL, (step, k, err)


def test_record_success_updates_memory_and_target(pair):
    ja, ta = pair
    for seed, n in ((20, 40), (21, 30), (22, 100)):
        tr = _transitions(n, seed)
        ja.record_success(*tr)
        ta.record_success(*tr)
        assert ta.updates == ja.updates and ta.records == ja.records
        assert ta.noise_scale == ja.noise_scale
        assert ta.stats == ja.stats
    # 170 records at update_freq 16: 10 updates; refresh every 48 // 16 = 3.
    assert ta.updates == 10 and ta.buffer.size == 170
    want_noise = 0.1
    for _ in range(10):
        want_noise = max(0.01, want_noise * 0.995)
    assert ta.noise_scale == want_noise
    assert len(ta.light_memory) == len(ja.light_memory) == 20
    np.testing.assert_allclose(np.stack(ta.light_memory),
                               np.stack(ja.light_memory), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ta.light_prototype(), ja.light_prototype(),
                               rtol=0, atol=1e-5)
    assert len(ta.losses) == len(ja.losses) == 10
    np.testing.assert_allclose(ta.losses, ja.losses, rtol=1e-4)
    # The target was refreshed at update 9 and the encoder moved once more.
    want_t = jax_flat(ja.params, ("target_encoder",))
    got_t = port_flat(ta, ("target_encoder",))
    for k in want_t:
        assert np.abs(got_t[k] - want_t[k]).max() <= PARAM_TOL, k
    enc = port_flat(ta, ("encoder",))
    assert any(not np.array_equal(enc[k.replace("target_encoder", "encoder")],
                                  v) for k, v in got_t.items())


def test_record_success_caps_updates(pair):
    ja, ta = pair
    tr = _transitions(16 * 70, 30)           # 70 crossings in one call
    ja.record_success(*tr)
    ta.record_success(*tr)
    assert ta.updates == ja.updates == 64
    assert ta.noise_scale == ja.noise_scale


def test_choose_direction_research(pair):
    ja, ta = pair
    obs = _transitions(8, 40)[0]
    noise = torch.from_numpy(np.random.RandomState(41).randn(8, 2)
                             .astype(np.float32))
    a, info = ta.choose_direction_research(obs, noise=noise)
    assert info == {"strategy": "exploration", "noise_scale": 0.1,
                    "memory_size": 0}
    mean = ta.choose_direction_batch(torch.from_numpy(obs))
    np.testing.assert_array_equal(
        a, torch.clamp(mean + noise * 0.1, -1, 1).numpy())
    want = np.asarray(ja.choose_direction_batch(jnp.asarray(obs)))
    assert np.abs(mean.numpy() - want).max() <= 1e-5
    one, _ = ta.choose_direction_research(obs[0], exploration_phase=True)
    assert one.shape == (2,) and ta.choice_calls == 9


def test_checkpoints_both_ways(pair, tmp_path):
    ja, ta = pair
    ta.update(_transitions(32, 50))
    ta.light_memory = [np.full(NARROW["z_dim"], 0.5, np.float32)]
    ta.noise_scale, ta.updates = 0.0425, 7
    path = tmp_path / "port.npz"
    ta.save(path)
    params, cfg, extra = jax_load_fb(path, JaxConfig(**CFG))
    assert cfg == FBConfig(**CFG).to_dict()
    assert extra["noise_scale"] == 0.0425 and extra["updates"] == 7
    np.testing.assert_array_equal(extra["light_memory"][0],
                                  ta.light_memory[0])
    want = port_flat(ta, PARTS)
    got = jax_flat(params, PARTS)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # JAX -> port: JAX's agent after a step, read by the port's load_fb.
    ja.params, ja.opt_state, _, _ = ja._update_step(
        ja.params, ja.opt_state,
        tuple(jnp.asarray(b) for b in _transitions(32, 51)))
    ja.save(tmp_path / "jax.npz")
    nets, _, extra = load_fb(tmp_path / "jax.npz", FBConfig(**CFG))
    assert extra["light_memory"] == [] and extra["updates"] == 0
    want = jax_flat(ja.params, PARTS)
    for part in PARTS:
        for k, v in flat_params(nets[part], f"{part}::").items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    # The port's own round trip keeps the optimiser-free state.
    tb = FBResearchAgent(FBConfig(**CFG), seed=5, device="cpu")
    tb.load(path)
    for k, v in port_flat(tb, PARTS).items():
        np.testing.assert_array_equal(v, port_flat(ta, PARTS)[k])
    assert tb.noise_scale == 0.0425 and tb.updates == 7


def test_save_fb_writes_jax_keys(tmp_path):
    """The keys and shapes JAX's ``save_fb`` writes for a fresh agent."""
    ja = JaxAgent(JaxConfig(**CFG), seed=1)
    ja.save(tmp_path / "j.npz")
    ta = FBResearchAgent(FBConfig(**CFG), seed=1, device="cpu")
    save_fb(tmp_path / "t.npz", ta.nets, ta.config)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert set(j.files) == set(t.files)
        for k in j.files:
            assert j[k].shape == t[k].shape and j[k].dtype == t[k].dtype, k
