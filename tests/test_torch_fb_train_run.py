"""A whole training run of the port's FB trainer
(raytracer_tpu_torch/fb/trainer.py) held against JAX's
(raytracer_tpu/fb/trainer.py), fed the same draws, on the CPU.

Both run ``ChandelierOnlyTrainer`` at a narrow config (``CFG``: 4 scenes
of ``WALKERS`` walkers, 4 steps) through the three chunks of
``tools/ship_models.py::chunks(4, 0.5)`` (1 / 1 / 2 scenes at guide_prob
0, 0.25, 0.5; each chunk restarts at variation 0, as both recipes do), from one set of
initial parameters (JAX's, carried in by ``resume_from``) and one replay
generator (``np.random.default_rng(seed)`` in both agents).  The port's
walk takes its planes from JAX's key schedule (``walk_draws``
overridden: one ``split(key)`` a scene, ``jax_walk_draws`` of
tests/test_torch_fb_walk.py).  JAX's walk runs op by op
(``jax.disable_jit()``) and the port's with XLA's float32 ``sin``,
``cos``, ``acos``, ``atan2`` and ``log1p`` (``XLA_MATH``): jitted XLA
fuses multiply-adds and its CPU transcendentals differ from PyTorch's by
an ulp, which the walk test bounds (2e-3) but which would hide a fault
here.  With both, one walk is the other bit for bit.

Dtype: float32.  Both agents keep the replay buffer as float32 numpy and
their parameters in float32 (flax's and the port's default), and cast
every batch to float32 before an update; float64 is open to neither.

* Through the unguided chunk, where the walk does not depend on the
  parameters, exactly: every scene's hit rate, the buffer's contents,
  size and position, the record and update counts, the statistics, the
  noise scale and the light memory's length; its latents (the encoder's
  float32 products, summed in another order) within ``LATENT_TOL``.
* The run is chaotic: Adam and the guided walks amplify rounding.  A
  twin of the port's trainer, its encoder's initial parameters one ulp
  up, drifts from the port as the port drifts from JAX (measured, the
  largest parameter gap after each chunk: twin 6.3e-6, 1.5e-3, 2.4e-2;
  JAX 4.3e-6, 4.1e-4, 2.3e-2; the guide's: twin 1.2e-5, 0.16, 1.15; JAX
  1.2e-5, 0.023, 1.24).  So after each chunk the parameters
  and the live agent's guide (``FBResearchAgent.guide()`` against JAX's
  ``guide_apply``, on the buffer's first observations) are held within
  ``DRIFT_FACTOR`` times the twin's gap.  That bound is loose (the
  twin's guide gap reaches the guide's own size by the last chunk), so:
* Each guided chunk's first walk is held without the chaos: the port's
  trainer, its agent loaded from JAX's state at the chunk's start
  (parameters, noise scale, light memory), walks the chunk's first scene
  on JAX's draws through its own ``train_on_scene``.  Its noise and
  prototype equal JAX's, its live guide is within ``GUIDE_TOL`` of JAX's
  (measured 4.2e-6: the matmuls' summation order), and its walk is JAX's
  first walk of the chunk, flags equal and floats within the walk test's
  bounds.  A guided walk that ignores ``guide_prob``, uses the wrong
  noise scale or steers by the wrong prototype fails it.
* The guided chunks walk through the guide in both trainers, every scene;
  their hits per scene agree within 3 sigma of two Poisson counts, and
  the noise scale is the update count's in both.

The protocol pin: ``train-chandelier --scenes 320`` run through the
port's recipe gives the scene sequence recorded in
``models/fb_chandelier_training_report.json`` (v0–v79, v0–v79, v0–v159):
the shipped teacher is the 320-scene protocol, not the default 160.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.fb.trainer as jax_trainer_mod
import raytracer_tpu_torch.fb.trainer as port_trainer_mod
from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.fb.trajectory import generate_trajectories as jax_walk
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.trainer import ChandelierOnlyTrainer
from raytracer_tpu_torch.fb.trajectory import generate_trajectories as port_walk
from raytracer_tpu_torch.tools import ship_models

from test_torch_fb_learner import jax_flat, port_flat
from test_torch_fb_learner import (  # noqa: F401  (autouse fixture)
    hidden_loader_stub, without_leaked_loader_stub)
from test_torch_fb_walk import (WALK_CLOSE, WALK_CLOSE_SHARE, WALK_TOL,
                                 jax_walk_draws)
from test_torch_scene import one_torch_thread  # noqa: F401

REPORT = (Path(__file__).resolve().parents[1] / "models"
          / "fb_chandelier_training_report.json")

CFG = dict(z_dim=16, e_hidden_dim=64, f_hidden_dim=64, b_hidden_dim=32,
           batch_size=32, update_freq=64, buffer_capacity=10_000,
           max_bounces=4)
# JAX's walk runs op by op, ~3.5 s a scene at 64 spheres and nearly the
# same at any walker count: 4 scenes (chunks 1 / 1 / 2) of 1,024 walkers,
# whose small-light hits in the unguided scene fill the light memory, so
# the next two chunks walk guided.
SCENES = 4
WALKERS = 1024
SEED = 0
LATENT_TOL = 1e-5
DRIFT_FACTOR = 2.0
GUIDE_ROWS = 2048
GUIDE_TOL = 1e-5


def _xla(name):
    f = getattr(jnp, name)

    def g(*xs):
        with jax.enable_x64(False):
            return torch.from_numpy(np.array(f(*(x.numpy() for x in xs))))
    return g


XLA_MATH = {"sin": "sin", "cos": "cos", "acos": "arccos",
            "atan2": "arctan2", "log1p": "log1p"}


class KeyedChandelier(ChandelierOnlyTrainer):
    """The port's trainer with each walk's planes from JAX's key schedule:
    the key seeded ``seed + 17`` and split once a scene, as JAX's
    ``train_on_scene`` splits its own; ``guided`` counts the guided
    walks."""

    def __init__(self, *a, seed=0, **kw):
        super().__init__(*a, seed=seed, **kw)
        self.key = jax.random.key(seed + 17)
        self.guided = 0

    def walk_draws(self, episodes, scene, guided):
        self.key, k = jax.random.split(self.key)
        self.guided += guided
        return jax_walk_draws(k, episodes, scene.num_spheres,
                              self.config.max_bounces, self.START_BIAS,
                              guided)


@functools.lru_cache(maxsize=None)
def _jitted(apply):
    """JAX's guide jitted, as inside its jitted walk (op by op it is flax's
    eager apply, ~1 s a call): the guided chunks are held within the
    run's own drift, not bit for bit."""
    jitted = jax.jit(apply)

    def guide(*a):
        with jax.disable_jit(False):
            return jitted(*a)
    return guide


def _noise(updates):
    """The noise scale after ``updates`` Adam steps (both agents)."""
    c = FBConfig(**CFG)
    n = c.noise_scale
    for _ in range(updates):
        n = max(c.min_noise, n * c.noise_decay)
    return n


def _snapshot(tr, params, guide):
    ag = tr.agent
    b = ag.buffer
    return {
        "hit_rates": [p["hit_rate"] for p in tr.all_performances],
        "scenes": [p["scene"] for p in tr.all_performances],
        "buffer": {f: getattr(b, f)[:b.size].copy()
                   for f in ("obs", "action", "next_obs", "reward",
                             "hit_light")},
        "size_pos": (b.size, b.pos),
        "records": ag.records, "updates": ag.updates,
        "stats": dict(ag.stats), "noise": ag.noise_scale,
        "light_memory": np.array(ag.light_memory),
        "params": params, "guide": guide,
    }


def _port_guide(ag, obs):
    with torch.no_grad():
        return ag.guide()(torch.from_numpy(obs)).numpy()


def _walk_from(start, gp, key, tmp):
    """The port's trainer with its agent loaded from ``start`` (JAX's
    parameters, noise scale and light memory) walks the first scene of a
    chunk at ``guide_prob`` ``gp`` on JAX's ``key``, through its own
    ``train_on_scene``: the walk it would feed its agent (which here
    records nothing), and the agent."""
    probe = ChandelierOnlyTrainer(
        num_training_scenes=1, config=FBConfig(**CFG), output_dir=tmp,
        seed=SEED, resume_from=str(start), device="cpu")
    probe.guide_prob = gp
    probe.HINDSIGHT = False
    probe.walk_draws = lambda e, scene, guided: jax_walk_draws(
        key, e, scene.num_spheres, probe.config.max_bounces,
        probe.START_BIAS, guided)
    walks = []

    def capture(*a, **kw):
        walks.append((kw.get("guide") is not None,
                      port_walk(*a, **kw)))
        return walks[-1][1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_trainer_mod, "generate_trajectories", capture)
        mp.setattr(probe.agent, "record_success", lambda *a: None)
        scene, name, _ = probe.make_scene(0)
        probe.train_on_scene(scene, name, WALKERS)
    (guided, walk), = walks
    assert guided
    return walk, probe.agent


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    """JAX's trainer, the port's and the port's twin through the three
    chunks: snapshots of the three after each chunk, the number of guided
    walks JAX ran, and for each guided chunk the first walk of JAX's run
    beside the port's from JAX's state at the chunk's start
    (``_walk_from``)."""
    tmp = tmp_path_factory.mktemp("train_run")
    plan = ship_models.chunks(SCENES, 0.5)
    assert plan == [(1, 0.0), (1, 0.25), (2, 0.5)]
    jax_walks = []

    def jax_walk_op_by_op(*a, **kw):
        apply = kw.get("guide_apply")
        if apply is not None:
            kw["guide_apply"] = _jitted(apply)
        with jax.disable_jit():
            walk = jax_walk(*a, **kw)
        jax_walks.append((a[1], apply is not None, walk))
        return walk

    with hidden_loader_stub(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_mod, "generate_trajectories",
                   jax_walk_op_by_op)
        for name, jname in XLA_MATH.items():
            mp.setattr(torch, name, _xla(jname))
        jt = jax_trainer_mod.ChandelierOnlyTrainer(
            num_training_scenes=SCENES, config=JaxConfig(**CFG),
            output_dir=tmp / "jax", seed=SEED)
        init = tmp / "init.npz"
        jt.agent.save(init)
        port, twin = (KeyedChandelier(
            num_training_scenes=SCENES, config=FBConfig(**CFG),
            output_dir=tmp / name, seed=SEED, resume_from=str(init),
            device="cpu") for name in ("port", "twin"))
        with torch.no_grad():
            for p in twin.agent.encoder.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, np.inf)))
        snaps, walks = [], []
        for c, (n, gp) in enumerate(plan):
            ja = jt.agent
            start = tmp / f"jax_chunk{c}.npz"
            ja.save(start)
            at_start = dict(params=ja.params, noise=ja.noise_scale,
                            proto=ja.light_prototype())
            first = len(jax_walks)
            for tr in (jt, port, twin):
                tr.guide_prob = gp
                tr.num_training_scenes = n
                tr.run_training(num_scenes=n, scenes_per_batch=20,
                                training_steps_per_scene=WALKERS)
            if gp > 0:
                key, guided, want = jax_walks[first]
                assert guided
                got, agent = _walk_from(start, gp, key, tmp / f"probe{c}")
                obs = got.obs.reshape(-1, 22)[:GUIDE_ROWS]
                walks.append({
                    "jax": want, "port": got,
                    "noise": (agent.noise_scale, at_start["noise"]),
                    "proto": (agent.light_prototype(), at_start["proto"]),
                    "guide": (_port_guide(agent, obs.numpy()), np.asarray(
                        _jitted(ja.guide_apply)(
                            at_start["params"], jnp.asarray(obs.numpy()),
                            jnp.asarray(at_start["proto"]))))})
            obs = ja.buffer.obs[:GUIDE_ROWS].copy()
            snaps.append({
                "jax": _snapshot(jt, jax_flat(ja.params), np.asarray(
                    _jitted(ja.guide_apply)(
                        ja.params, jnp.asarray(obs),
                        jnp.asarray(ja.light_prototype())))),
                "port": _snapshot(port, port_flat(port.agent),
                                  _port_guide(port.agent, obs)),
                "twin": _snapshot(twin, port_flat(twin.agent),
                                  _port_guide(twin.agent, obs))})
    jax_guided = sum(g for _, g, _ in jax_walks)
    return snaps, jax_guided, (port.guided, twin.guided), walks


def _gap(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def test_unguided_chunk_equal_exactly(runs):
    want, got = runs[0][0]["jax"], runs[0][0]["port"]
    assert got["scenes"] == want["scenes"] == ["chandelier_scene_v0"]
    assert got["hit_rates"] == want["hit_rates"]
    assert got["size_pos"] == want["size_pos"]
    for f, w in want["buffer"].items():
        np.testing.assert_array_equal(got["buffer"][f], w, err_msg=f)
    assert got["records"] == want["records"]
    assert got["updates"] == want["updates"] > 0
    assert got["stats"] == want["stats"]
    assert got["noise"] == want["noise"]
    # The light memory filled (so the next chunks walk guided), its
    # latents within LATENT_TOL.
    assert len(got["light_memory"]) == len(want["light_memory"]) > 0
    np.testing.assert_allclose(got["light_memory"], want["light_memory"],
                               rtol=0, atol=LATENT_TOL)


@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_drift_from_jax_within_rounding(runs, chunk):
    """The port's gap from JAX, parameters and guide, within DRIFT_FACTOR
    times its gap from its one-ulp twin; each agent's noise scale is its
    update count's."""
    s = runs[0][chunk]
    assert set(s["port"]["params"]) == set(s["jax"]["params"])
    twin_gap = _gap(s["twin"]["params"], s["port"]["params"])
    jax_gap = _gap(s["jax"]["params"], s["port"]["params"])
    assert 0 < jax_gap <= DRIFT_FACTOR * twin_gap, (jax_gap, twin_gap)
    twin_g = float(np.abs(s["twin"]["guide"] - s["port"]["guide"]).max())
    jax_g = float(np.abs(s["jax"]["guide"] - s["port"]["guide"]).max())
    assert jax_g <= DRIFT_FACTOR * twin_g, (jax_g, twin_g)
    for side in ("jax", "port", "twin"):
        assert s[side]["noise"] == _noise(s[side]["updates"]), side
    assert abs(s["port"]["updates"] - s["jax"]["updates"]) <= \
        max(2, 2 * abs(s["port"]["updates"] - s["twin"]["updates"]))


@pytest.mark.parametrize("chunk", [0, 1])
def test_guided_walk_from_jax_state(runs, chunk):
    """The first walk of each guided chunk, the port's from JAX's state at
    the chunk's start (parameters, noise scale, light memory) on JAX's
    draws, through the port trainer's own ``train_on_scene``: the noise
    and the prototype equal JAX's, the live guide within ``GUIDE_TOL`` of
    JAX's on the walk's first ``GUIDE_ROWS`` observations, and the walk
    JAX's (no training between them, so no chaos): its flags equal, its
    floats within the bounds of tests/test_torch_fb_walk.py (``WALK_TOL`` of
    ``max(|JAX value|, 1)``, ``WALK_CLOSE_SHARE`` of them within
    ``WALK_CLOSE``)."""
    w = runs[3][chunk]
    assert w["noise"][0] == w["noise"][1]
    np.testing.assert_array_equal(*w["proto"])
    gap = float(np.abs(w["guide"][0] - w["guide"][1]).max())
    assert gap <= GUIDE_TOL, gap
    got, want = w["port"], w["jax"]
    for f in ("valid", "hit_light", "hit_small", "episode_hit"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    v = got.valid.numpy()
    assert v.any() and got.hit_light.any()
    for f in ("obs", "action", "next_obs", "reward"):
        a, b = getattr(got, f).numpy()[v], np.asarray(getattr(want, f))[v]
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
        assert rel.max() <= WALK_TOL, (f, rel.max())
        assert (rel <= WALK_CLOSE).mean() >= WALK_CLOSE_SHARE, \
            (f, (rel <= WALK_CLOSE).mean())


def test_guided_chunks_hits(runs):
    """Chunks 2 and 3 walk through the live guide in all three trainers,
    every scene, and their hits per scene agree within 3 sigma of two
    Poisson counts (a walker that moves by an ulp may land elsewhere)."""
    snaps, jax_guided, port_guided, _ = runs
    assert jax_guided == 3 and port_guided == (3, 3)
    want, got = snaps[2]["jax"], snaps[2]["port"]
    assert got["scenes"] == want["scenes"]
    assert len(got["hit_rates"]) == SCENES
    for a, b in zip(got["hit_rates"], want["hit_rates"]):
        na, nb = (round(x * WALKERS / 100.0) for x in (a, b))
        assert abs(na - nb) <= 3.0 * np.sqrt(na + nb), (na, nb)


def test_chandelier_protocol_scene_sequence(tmp_path, monkeypatch):
    """``train-chandelier --scenes 320`` visits the scenes the shipped
    teacher's report records, in order; 160 visits half as many, in the
    chunks 40 / 40 / 80.  The report's hit rates climb quarter by
    quarter."""
    want = [p["scene"] for p in
            json.loads(REPORT.read_text())["all_performances"]]
    assert len(want) == 320
    seen = []

    def record(self, scene, name, episodes):
        seen.append(name)
        return 0.0
    monkeypatch.setattr(ChandelierOnlyTrainer, "train_on_scene", record)
    monkeypatch.setattr(ChandelierOnlyTrainer, "test_on_chandelier",
                        lambda self, num_tests=200: {})
    narrow = ["--z-dim", "4", "--e-hidden", "8", "--f-hidden", "8",
              "--b-hidden", "8", "--device", "cpu"]
    for scenes in (320, 160):
        seen.clear()
        ship_models.main(["train-chandelier", "--scenes", str(scenes),
                          "--out", str(tmp_path / f"t{scenes}.npz"),
                          "--workdir", str(tmp_path / f"w{scenes}")]
                         + narrow)
        q = scenes // 4
        expect = [f"chandelier_scene_v{i}"
                  for n in (q, q, 2 * q) for i in range(n)]
        assert seen == expect
        assert (seen == want) == (scenes == 320)
    # The shipped run's mean hit rate over each quarter of its scenes.
    rates = [p["hit_rate"] for p in
             json.loads(REPORT.read_text())["all_performances"]]
    q = [float(np.mean(rates[i:i + 80])) for i in range(0, 320, 80)]
    assert q[0] < q[1] < q[2] < q[3]
