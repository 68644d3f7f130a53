"""The port's shaped env and curriculum (raytracer_tpu_torch/agents/
adaptive.py) and the trainers' parameter transfer, held against the JAX
package's on the CPU.

The shaped env runs whole episodes against JAX's op by op (64-bit mode
off), with XLA's sines and cosines in both packages for bit-for-bit
equality (``xla_trig``, as ``tests/test_torch_rl_env.py`` does).  Half
the lanes take light-seeking actions (``tools/shaping_edges.py``) so that
the light bonus, the streak, the reflective bonus, the short-path penalty
and the counters of finished lanes resting on a light all fire.  The
−0.5 miss rewrite cannot fire: the base RL env rewards a pre-move miss
with −1.0 (0.0 once done), never −0.1, in both packages; the tests assert
that its count is 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.agents import adaptive as jax_adaptive
from raytracer_tpu.agents.sac import SACConfig as JaxSACConfig
from raytracer_tpu.agents.sac import SACTrainer as JaxSACTrainer
from raytracer_tpu.env import scenes as jax_scenes
from raytracer_tpu.env.raytracer_env import RayTracerEnv as JaxEnv
from raytracer_tpu_torch.agents import adaptive
from raytracer_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from raytracer_tpu_torch.agents.sac import SACConfig, SACTrainer
from raytracer_tpu_torch.env import scenes
from raytracer_tpu_torch.env.raytracer_env import RayTracerEnv
from raytracer_tpu_torch.tools.shaping_edges import (
    TERMS, light_seeking_actions, shaping_terms)

from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 64
MAX_BOUNCES = 3
STEPS = MAX_BOUNCES + 4          # finished lanes go on for a few steps
SCENES = {"training_scene_v1": (jax_scenes.training_scene_v1,
                                scenes.training_scene_v1),
          "dynamic_scene_3": (lambda: jax_scenes.dynamic_scene(3),
                              lambda device: scenes.dynamic_scene(
                                  3, device=device))}


def xla_trig_patch(mp):
    """``torch.sin``/``torch.cos`` as XLA's float32 ones (CPU tensors)."""
    def xla(name):
        f = getattr(jnp, name)

        def g(x):
            with jax.enable_x64(False):
                return torch.from_numpy(np.array(f(x.numpy())))
        return g
    mp.setattr(torch, "sin", xla("sin"))
    mp.setattr(torch, "cos", xla("cos"))


@pytest.fixture
def xla_trig(monkeypatch):
    xla_trig_patch(monkeypatch)


def port_env(name, impl="kernel", **over):
    ts, gl, pl = SCENES[name][1](device="cpu")
    kw = dict(image_width=64, image_height=64, fov=90,
              max_bounces=MAX_BOUNCES, variant="rl")
    kw.update(over)
    return adaptive.AdaptiveRewardRayTracerEnv(
        RayTracerEnv(ts, global_lights=gl, point_lights=pl, impl=impl, **kw))


def jax_env(name):
    js, gl, pl = SCENES[name][0]()
    return jax_adaptive.AdaptiveRewardRayTracerEnv(
        JaxEnv(js, image_width=64, image_height=64, fov=90,
               max_bounces=MAX_BOUNCES, global_lights=gl, point_lights=pl,
               variant="rl"))


def port_episode(env, pixel, actions):
    """Per step: (obs, reward, terminated, done, consecutive, total),
    numpy, after the reset's obs."""
    s, o = env.reset(B, pixel=pixel)
    outs = [(o.numpy(),)]
    for a in actions:
        s, o, r, t, _ = env.step(s, torch.from_numpy(a))
        outs.append(tuple(x.numpy() for x in (
            o, r, t, s.done, s.consecutive_light_hits, s.total_light_hits)))
    return outs


@pytest.fixture(scope="module")
def episodes():
    """Each scene's pixels, actions (even lanes light-seeking, odd lanes
    uniform, found with XLA's trig so that they aim in JAX's episode too),
    the port's counts of each shaping term, and JAX's episode op by op."""
    runs = {}
    rng = np.random.default_rng(7)
    for name in SCENES:
        env = port_env(name)
        pixel = rng.integers(0, 64, (B, 2))
        uniform = (rng.random((STEPS, B, 2)) * [np.pi / 2, 2 * np.pi]
                   ).astype(np.float32)
        actions, counts = [], dict.fromkeys(TERMS, 0)
        with pytest.MonkeyPatch.context() as mp:
            xla_trig_patch(mp)
            s, _ = env.reset(B, pixel=pixel)
            for t in range(STEPS):
                fallback = torch.from_numpy(uniform[t])
                seek, _ = light_seeking_actions(env, s, fallback)
                a = torch.where((torch.arange(B) % 2 == 0)[:, None], seek,
                                fallback)
                ns, _, _, _, _ = env.step(s, a)
                for k, v in shaping_terms(env, s, a, ns).items():
                    counts[k] += v
                actions.append(a.numpy())
                s = ns
        je = jax_env(name)
        with jax.enable_x64(False), jax.disable_jit():
            js, jo = je.reset(jax.random.key(0), batch=B,
                              pixel=jnp.asarray(pixel, jnp.int32))
            want = [(np.asarray(jo),)]
            for a in actions:
                js, jo, jr, jt, _ = je.step(js, jnp.asarray(a))
                want.append(tuple(np.asarray(x) for x in (
                    jo, jr, jt, js.done, js.consecutive_light_hits,
                    js.total_light_hits)))
        runs[name] = pixel, actions, counts, want
    return runs


@pytest.mark.parametrize("name", list(SCENES))
def test_shaped_episode_matches_jax_op_by_op(name, episodes, xla_trig):
    """Reset and ``max_bounces + 4`` shaped steps over 64 lanes: obs,
    rewards, terminated, done and both counters bit for bit; every
    reachable term fired."""
    pixel, actions, counts, want = episodes[name]
    for k in TERMS:
        if k == "miss_rewrite":
            assert counts[k] == 0
        else:
            assert counts[k] > 0, (k, counts)
    got = port_episode(port_env(name), pixel, actions)
    for i, (w, g) in enumerate(zip(want, got)):
        for wi, gi in zip(w, g):
            assert gi.dtype == wi.dtype, (i, gi.dtype, wi.dtype)
            np.testing.assert_array_equal(gi, wi, err_msg=f"call {i}")


def test_shaped_episode_with_torch_trig_within_bounds(episodes):
    """PyTorch's own sin/cos, held to the base env's bounds
    (test_torch_rl_env.py): at most 2 of the 64 lanes leave 2e-4 on
    rewards or 2e-3 on observations; done and both counters equal on
    every lane."""
    for name in SCENES:
        pixel, actions, _, want = episodes[name]
        got = port_episode(port_env(name), pixel, actions)
        off = np.zeros(B, bool)
        for w, g in zip(want[1:], got[1:]):
            off |= np.abs(g[0] - w[0]).max(-1) > 2e-3
            off |= np.abs(g[1] - w[1]) > 2e-4
            for i in (2, 3, 4, 5):
                np.testing.assert_array_equal(g[i], w[i])
        assert off.sum() <= 2, (name, off.sum())


def test_shaped_kernel_route_equals_plain_route_on_cpu(episodes):
    """On CPU tensors the kernel route runs the kernels' plain versions:
    the same shaped episodes as ``impl="plain"``."""
    pixel, actions, _, _ = episodes["dynamic_scene_3"]
    runs = [port_episode(port_env("dynamic_scene_3", impl=impl), pixel,
                         actions) for impl in ("kernel", "plain")]
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_shaped_env_forwards_the_base_env():
    env = port_env("training_scene_v1")
    assert env.max_bounces == MAX_BOUNCES and env.variant == "rl"
    assert env.device == torch.device("cpu")
    s, o = env.reset(4, generator=torch.Generator().manual_seed(0))
    assert s.done is s.env.done and s.total_reward is s.env.total_reward
    assert s.total_light_hits.dtype == torch.int32 and o.shape == (4, 18)


@pytest.mark.parametrize("sched", [(), (10, 20), (3, 0), (0, 5)])
def test_schedule_phase_for_matches_jax(sched):
    want = jax_adaptive.CurriculumSchedule(*sched)
    got = adaptive.CurriculumSchedule(*sched)
    for steps in list(range(0, 40)) + [9_999, 10_000, 29_999, 30_000,
                                       10 ** 6]:
        assert got.phase_for(steps) == want.phase_for(steps), steps


@dataclasses.dataclass
class RecConfig:
    ent_coef: float = 0.5
    width: int = 3


@dataclasses.dataclass
class NoEntConfig:
    width: int = 3


def recording_trainer(log):
    class Recorder:
        def __init__(self, env, config=None, seed=0, **kw):
            self.env = env
            log.append(("init", env, config, seed, sorted(kw.items())))

        def set_parameters(self, params):
            log.append(("set_parameters", params))

        def get_parameters(self):
            log.append(("get_parameters",))
            return f"params-of-{self.env}"

        def train(self, steps):
            log.append(("train", steps))
            return {"steps": steps}
    return Recorder


@pytest.mark.parametrize("kwargs", [
    dict(trainer_kwargs={"config": RecConfig(), "extra": 7}, seed=4),
    dict(trainer_kwargs={"config": NoEntConfig()}, phases=(2, 3),
         steps_per_phase=(5, 6), ent_coefs=(0.2, 0.1)),
    dict()])
def test_curriculum_sequence_matches_jax(kwargs):
    """The same recording trainer under both packages' flows: the same
    configs (only the first phase gets the caller's, its ``ent_coef``
    replaced), seeds, transfers and steps."""
    logs = []
    for mod in (jax_adaptive, adaptive):
        log = []
        tr, res = mod.train_with_curriculum(lambda p: f"env{p}",
                                            recording_trainer(log),
                                            **kwargs)
        logs.append((log, tr.env, res))
    assert logs[0] == logs[1]
    configs = [e[2] for e in logs[1][0] if e[0] == "init"]
    assert configs[1:] == [None] * (len(configs) - 1)


def dyn_env(phase):
    ts, gl, pl = scenes.dynamic_scene(phase, device="cpu")
    return RayTracerEnv(ts, image_width=64, image_height=64, fov=90,
                        max_bounces=4, global_lights=gl, point_lights=pl,
                        variant="rl")


def transfer_recorder(base, log):
    class Recorded(base):
        def set_parameters(self, params):
            super().set_parameters(params)
            log.append(("set", self.get_parameters()))

        def train(self, steps):
            out = super().train(steps)
            log.append(("trained", self.get_parameters()))
            return out
    return Recorded


def flat(params):
    if isinstance(params, torch.Tensor):
        return [params]
    return [t for k in sorted(params) for t in flat(params[k])]


def assert_same(a, b):
    fa, fb = flat(a), flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert torch.equal(x, y)


def test_ppo_curriculum_transfers_bit_for_bit():
    """JAX's test sizes (400 steps a phase, ``batch_envs=32``): phase k+1's
    parameters after ``set_parameters`` are phase k's final ones bit for
    bit, Adam still steps them, and ``get_parameters`` copies."""
    log = []
    tr, res = adaptive.train_with_curriculum(
        dyn_env, transfer_recorder(PPOTrainer, log),
        steps_per_phase=(400, 400, 400),
        trainer_kwargs={"config": PPOConfig(batch_envs=32, epochs=1,
                                            minibatches=2)})
    assert len(res) == 3 and [e[0] for e in log] == [
        "trained", "set", "trained", "set", "trained"]
    for i in (0, 2):
        assert_same(log[i + 1][1], log[i][1])
        assert any(not torch.equal(x, y) for x, y in zip(
            flat(log[i + 1][1]), flat(log[i + 2][1])))
    opt_params = {id(p) for g in tr.opt.param_groups for p in g["params"]}
    assert opt_params == {id(p) for p in tr.net.parameters()}
    snap = tr.get_parameters()
    key = next(iter(snap))
    before = snap[key].clone()
    with torch.no_grad():
        tr.net.state_dict()[key].add_(1.0)
    assert torch.equal(snap[key], before)


def test_sac_parameter_round_trip():
    env = dyn_env(1)
    a = SACTrainer(env, SACConfig(hidden=(16, 16)), seed=0)
    b = SACTrainer(env, SACConfig(hidden=(16, 16)), seed=5)
    with torch.no_grad():
        a.log_alpha.fill_(-0.25)
        for p in a.target_critic.parameters():
            p.mul_(0.5)
    params = a.get_parameters()
    assert set(params) == {"actor", "critic", "target_critic", "log_alpha"}
    keep = [id(p) for p in b.actor.parameters()]
    b.set_parameters(params)
    assert_same(b.get_parameters(), params)
    assert [id(p) for p in b.actor.parameters()] == keep
    assert {id(p) for g in b.actor_opt.param_groups for p in g["params"]} \
        == set(keep)
    assert b.log_alpha.requires_grad
    with torch.no_grad():
        a.log_alpha.fill_(3.0)
    assert float(params["log_alpha"]) == -0.25


def sac_config(cls):
    return cls(batch_envs=8, learning_starts=16, batch_size=16,
               buffer_size=512)


def test_sac_curriculum_completes_while_jax_raises():
    """The port's SAC carries its parameters across phases.  The JAX
    package's ``SACTrainer`` has no ``get_parameters``, so its curriculum
    raises after phase 1 (a known gap, ROADMAP.md)."""
    def jax_env(phase):
        js, gl, pl = jax_scenes.dynamic_scene(phase)
        return JaxEnv(js, image_width=16, image_height=16, fov=90,
                      max_bounces=1, global_lights=gl, point_lights=pl,
                      variant="rl")
    with pytest.raises(AttributeError, match="get_parameters"):
        jax_adaptive.train_with_curriculum(
            jax_env, JaxSACTrainer, steps_per_phase=(8, 8, 8),
            trainer_kwargs={"config": sac_config(JaxSACConfig)})

    log = []
    tr, res = adaptive.train_with_curriculum(
        dyn_env, transfer_recorder(SACTrainer, log),
        steps_per_phase=(96, 96, 96),
        trainer_kwargs={"config": sac_config(SACConfig)})
    assert len(res) == 3 and all(r["total_steps"] > 0 for r in res)
    for i in (0, 2):
        assert_same(log[i + 1][1], log[i][1])
