"""The port's FB trainer (raytracer_tpu_torch/fb/trainer.py, fb/agent.py)
held to JAX's (raytracer_tpu/fb/trainer.py) scene by scene, each held
scene starting from JAX's whole trainer state, in the regime of the
shipped chandelier protocol's guided chunk, on the CPU.

``CFG`` keeps tests/test_torch_fb_train_run.py's narrow widths and takes
the protocol's other settings: 8 steps a walk, an update every 100
records, a target refresh every 10 updates, ``START_BIAS="mixed"``,
``guide_prob`` 0.5, and a ring (``CAPACITY``) that fills in the second
scene and wraps again in each held scene.  JAX's trainer runs without
64-bit mode, as production does.  It starts with its noise at the floor,
walks chandelier v0 and v1 (the light memory fills, so every later walk
is guided), then holds two scenes: v2, and v3 with its small lights dark
(a scene without small lights, where the success signal is
``hit_light``).  JAX's walks run op by op (``jax.disable_jit()``, the
guide jitted: at these widths XLA's walk compiles cost more than the
walks), its updates jitted.

Each held scene starts four port trainers from JAX's state before the
scene, carried in whole by ``tests/fb_state_hold.py::carry`` (the
parameters, Adam's moments and count, the ring and its position, the
replay generator, the light memory, the noise scale and the counters):

* the port, walking on JAX's draws with ``XLA_MATH`` patched in, and its
  twin (encoder one ulp up).  Every walk flag equals JAX's, and so do
  the hits, the record and update counts, ``pos``/``size``, the
  statistics, the noise scale and the generator's state.  The floats of
  the rows the scene wrote are not bit for bit: the guide's matmuls sum
  in another order than XLA's, and 8 guided bounces carry that from step
  to step (measured: up to 4e-3 of ``max(|value|, 1)``, the twin's up to
  7e-3).  Their share above ``WALK_CLOSE`` is held within ``FACTOR``
  times the twin's, and every row the scene did not write is unchanged.
* the port fed JAX's walk (``fed``), and its twin.  The ring it leaves
  is JAX's bit for bit, so are its counters, noise scale and generator,
  and its parameters (target encoder included) after the scene's ~19
  updates are within ``FACTOR`` times the twin's gap: the updates start
  from one state on one set of transitions (measured: the largest
  parameter gap 2.4e-7 and 1.2e-7 against the twin's 3.4e-6 and 2.4e-7).
  Its live guide, light memory and prototype are held within ``FACTOR``
  times the twin's gap plus the rounding floors of
  tests/test_torch_fb_train_run.py (``GUIDE_TOL``, ``LATENT_TOL``).

Dtype: float32 (both agents' parameters, ring and batches).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytracer_tpu.fb.trainer as jax_trainer_mod
import raytracer_tpu_torch.fb.trainer as port_trainer_mod
from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.utils.checkpoint import _flatten
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.trainer import ChandelierOnlyTrainer
from raytracer_tpu_torch.utils.checkpoint import PARTS

from fb_state_hold import (FACTOR, FLAGS, LEARNED, RING, bump_encoder,
                           carry, compare, fed, jax_outcome, jax_state,
                           keyed, port_outcome, scene_key, walks, xla_math)
from test_torch_fb_learner import jax_flat, port_flat
from test_torch_fb_learner import (  # noqa: F401  (autouse fixture)
    hidden_loader_stub, without_leaked_loader_stub)
from test_torch_fb_train_run import GUIDE_TOL, LATENT_TOL
from test_torch_fb_walk import WALK_CLOSE
from test_torch_scene import one_torch_thread, port_scene  # noqa: F401

CAPACITY = 2048
CFG = dict(z_dim=16, e_hidden_dim=64, f_hidden_dim=64, b_hidden_dim=32,
           batch_size=32, update_freq=100, target_update_freq=1000,
           buffer_capacity=CAPACITY, max_bounces=8)
SEED = 0
WALKERS = 256
GUIDE_PROB = 0.5
GUIDE_ROWS = 1024
PREFIX = 2
# (tag, chandelier variation, small lights dark)
HELD = (("v2", 2, False), ("v3_no_small", 3, True))
TAGS = [h[0] for h in HELD]
SIDES = ("port", "twin", "fed", "fed_twin")


def _agent_state(ag) -> dict:
    """The port agent's training state, copied: parameters and Adam's
    ``(step, exp_avg, exp_avg_sq)`` under flax's flattened names."""
    adam = {}
    for part in LEARNED:
        for name, p in ag.nets[part].named_parameters():
            st = ag.optimizer.state[p]
            adam[f"{part}::{name.replace('.', '/')}"] = (
                float(st["step"]), st["exp_avg"].numpy().copy(),
                st["exp_avg_sq"].numpy().copy())
    b = ag.buffer
    return {"params": port_flat(ag, PARTS), "adam": adam,
            "ring": {f: getattr(b, f).copy() for f in RING},
            "size": b.size, "pos": b.pos,
            "rng": ag.rng.bit_generator.state, "noise": ag.noise_scale,
            "records": ag.records, "updates": ag.updates,
            "stats": dict(ag.stats),
            "light_memory": np.stack(ag.light_memory)}


def _dark_small_lights(scene):
    """JAX chandelier ``scene`` with its small lights no longer emissive."""
    return scene.replace(emitive=jnp.where(scene.radius < 0.5, 0.0,
                                           scene.emitive))


def _ring(tr):
    return {f: getattr(tr.agent.buffer, f).copy() for f in RING}


@pytest.fixture(scope="module")
def held(tmp_path_factory, one_torch_thread):  # noqa: F811
    """For each held scene: JAX's state before it, its outcome and ring
    after it, and the same of each port side (``SIDES``), with the port's
    state right after the carry."""
    tmp = tmp_path_factory.mktemp("chunk_hold")
    with hidden_loader_stub(), jax.enable_x64(False):
        jt = jax_trainer_mod.ChandelierOnlyTrainer(
            num_training_scenes=4, config=JaxConfig(**CFG),
            output_dir=tmp / "jax", seed=SEED, guide_prob=GUIDE_PROB)
        jt.agent.noise_scale = jt.agent.config.min_noise
        trainers = {side: ChandelierOnlyTrainer(
            num_training_scenes=1, config=FBConfig(**CFG),
            output_dir=tmp / side, seed=SEED, device="cpu")
            for side in SIDES}
        for i in range(PREFIX):
            scene, name, _ = jt.make_scene(i)
            with walks(jax_trainer_mod, op_by_op=True):
                jt.train_on_scene(scene, name, WALKERS)
        out = {}
        for tag, i, dark in HELD:
            scene, name, _ = jt.make_scene(i)
            pscene = trainers["port"].make_scene(i)[0]
            if dark:
                scene = _dark_small_lights(scene)
                pscene = port_scene(scene)
            pre = jax_state(jt)
            with walks(jax_trainer_mod, op_by_op=True) as seen:
                jt.train_on_scene(scene, name, WALKERS)
            (walk, guided), = seen
            obs = np.asarray(walk.obs).reshape(-1, 22)
            rows = obs[np.asarray(walk.valid).reshape(-1)][:GUIDE_ROWS]
            proto = jt.agent.light_prototype()
            res = {"pre": pre, "guided": {"jax": guided},
                   "jax": jax_outcome(jt, pre, walk, rows, proto),
                   "ring": {"jax": _ring(jt)}}
            for side, tr in trainers.items():
                carry(pre, tr)
                if side == "port":
                    res["carried"] = _agent_state(tr.agent)
                if side.endswith("twin"):
                    bump_encoder(tr.agent)
                tr.guide_prob = GUIDE_PROB
                keyed(tr, scene_key(pre))
                with contextlib.ExitStack() as stack:
                    if side.startswith("fed"):
                        stack.enter_context(fed(port_trainer_mod, walk))
                    stack.enter_context(xla_math())
                    pw = stack.enter_context(walks(port_trainer_mod))
                    tr.train_on_scene(pscene, name, WALKERS)
                (pwalk, res["guided"][side]), = pw
                res[side] = port_outcome(tr, pre, pwalk, rows, proto)
                res["ring"][side] = _ring(tr)
            out[tag] = res
    return out


def _counters_equal(got, want):
    for k in ("hits", "small_hits", "records", "updates", "size", "pos",
              "noise", "stats"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["rng"] == want["rng"]


def test_carry_is_jax_state(held):
    """Right after ``carry`` the port's agent holds JAX's state before the
    scene: the parameters, Adam's moments and count, the ring, its size
    and position, the generator's state, the light memory, the noise scale
    and the counters, all bit for bit."""
    for tag in TAGS:
        pre, got = held[tag]["pre"], held[tag]["carried"]
        want = jax_flat(pre["params"], PARTS)
        assert set(got["params"]) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got["params"][k], w, err_msg=k)
        adam, = (s for s in pre["opt_state"] if hasattr(s, "mu"))
        assert int(adam.count) == pre["updates"] > 0
        for part, mu, nu in zip(LEARNED, adam.mu, adam.nu):
            for k, w in _flatten(mu, part + "::").items():
                step, m, _ = got["adam"][k]
                assert step == int(adam.count), k
                np.testing.assert_array_equal(m, w, err_msg=k)
            for k, w in _flatten(nu, part + "::").items():
                np.testing.assert_array_equal(got["adam"][k][2], w,
                                              err_msg=k)
        for f in RING:
            np.testing.assert_array_equal(got["ring"][f], pre["ring"][f])
        for k in ("size", "pos", "rng", "noise", "records", "updates",
                  "stats"):
            assert got[k] == pre[k], k
        np.testing.assert_array_equal(got["light_memory"],
                                      np.stack(pre["light_memory"]))


@pytest.mark.parametrize("tag", TAGS)
def test_walk_flags_and_counters_equal(held, tag):
    """The held scene walks guided, on a full ring, with the noise at its
    floor, and its adds cross the ring's end; the port's walk flags, hits,
    counters, ring position, statistics, noise scale and generator state
    after it are JAX's."""
    res = held[tag]
    pre, want, got = res["pre"], res["jax"], res["port"]
    assert pre["size"] == CAPACITY and pre["light_memory"]
    assert pre["noise"] == FBConfig(**CFG).min_noise
    assert all(res["guided"].values()), res["guided"]
    for f in FLAGS:
        np.testing.assert_array_equal(got["flags"][f], want["flags"][f],
                                      err_msg=f)
    assert want["flags"]["valid"].any() and want["hits"] > 0
    _counters_equal(got, want)
    assert want["updates"] >= 10       # a target refresh inside the scene
    assert pre["pos"] + want["records"] > CAPACITY


@pytest.mark.parametrize("tag", TAGS)
def test_walk_rows(held, tag):
    """The rows the port's walk wrote, against JAX's relative to
    ``max(|JAX value|, 1)``: their share above ``WALK_CLOSE`` within
    ``FACTOR`` times the twin's against the port; every row the scene did
    not write unchanged."""
    res = held[tag]
    assert res["port"]["records"] == res["jax"]["records"]

    def rel(x, y):
        return np.concatenate([
            (np.abs(x["written"][f].astype(np.float64) - y["written"][f])
             / np.maximum(np.abs(y["written"][f]), 1.0)).reshape(-1)
            for f in RING])
    got, twin = rel(res["port"], res["jax"]), rel(res["twin"], res["port"])
    assert (twin > WALK_CLOSE).any()
    assert (got > WALK_CLOSE).mean() <= FACTOR * (twin > WALK_CLOSE).mean()
    n, pos = res["jax"]["records"], res["pre"]["pos"]
    untouched = np.ones(CAPACITY, bool)
    untouched[(pos + np.arange(n)) % CAPACITY] = False
    assert untouched.any()
    for f in RING:
        np.testing.assert_array_equal(res["ring"]["port"][f][untouched],
                                      res["ring"]["jax"][f][untouched],
                                      err_msg=f)


@pytest.mark.parametrize("tag", TAGS)
def test_fed_walk_ring_and_counters_equal(held, tag):
    """The port fed JAX's walk records what JAX recorded: the whole ring,
    its position, the counters, statistics, noise scale and generator
    state after the scene are JAX's bit for bit, and the light memory
    holds as many rows."""
    res = held[tag]
    want, got = res["jax"], res["fed"]
    for f in RING:
        np.testing.assert_array_equal(res["ring"]["fed"][f],
                                      res["ring"]["jax"][f], err_msg=f)
    _counters_equal(got, want)
    assert len(got["light_memory"]) == len(want["light_memory"])


@pytest.mark.parametrize("tag", TAGS)
def test_fed_walk_updates_within_twin(held, tag):
    """After the scene's updates on JAX's transitions, the port's
    parameters (target encoder included; the largest gap and the gap's
    norm over the scene's move) are within ``FACTOR`` times its one-ulp
    twin's gap; its live guide (both packages' parameters through the
    port's guide against JAX's prototype, ``guide_on``), light memory and
    prototype too, give or take their own rounding floors (measured: the
    guide 3.7e-5 and 1.0e-5 against the twin's 4.5e-5 and 2.8e-6)."""
    res = held[tag]
    start = jax_flat(res["pre"]["params"], PARTS)
    jax_gap = compare(res["fed"], res["jax"], start)
    twin_gap = compare(res["fed_twin"], res["fed"], start)
    for k in ("param_gap", "param_rel_l2"):
        assert 0 < jax_gap[k] <= FACTOR * twin_gap[k], (k, jax_gap[k],
                                                        twin_gap[k])
    # The guide and the latents add their own conditioning: the floors
    # tests/test_torch_fb_train_run.py holds them to (a guide at one
    # parameter set in two summation orders, the encoders' latents).
    for k, floor in (("guide_gap", GUIDE_TOL), ("memory_gap", LATENT_TOL),
                     ("proto_gap", LATENT_TOL)):
        assert jax_gap[k] <= FACTOR * twin_gap[k] + floor, \
            (k, jax_gap[k], twin_gap[k])
