"""The port's RL agents (raytracer_tpu_torch/agents/) held against the JAX
package's on the CPU: the networks, the PPO rollout, GAE, loss, gradient
and update, the SAC update (plain and weighted), tabular Q, on the same
weights, batches and draws (JAX's, reproduced from its key schedule).

Bounds: JAX's rollout and updates run jitted, where XLA multiplies by the
reciprocals of constant divisors and sums matrix products in another order
than PyTorch's CPU kernels; the differences stay at float32 rounding
(stated at each check).  Adam's first steps are about ``lr * sign(g)``, so
a gradient element within rounding of zero could step the other way: the
updates here are held to 1e-6 of JAX's parameters, which no such flip
would pass, and none occurs on these batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.agents import networks as jax_networks
from raytracer_tpu.agents.ppo import PPOConfig as JaxPPOConfig
from raytracer_tpu.agents.ppo import PPOTrainer as JaxPPO
from raytracer_tpu.agents.sac import SACConfig as JaxSACConfig
from raytracer_tpu.agents.sac import SACTrainer as JaxSAC
from raytracer_tpu.agents.tabular_q import TabularQConfig as JaxQConfig
from raytracer_tpu.agents.tabular_q import TabularQTrainer as JaxQ
from raytracer_tpu_torch.agents import analytics, tabular_q
from raytracer_tpu_torch.agents.networks import (PPOActorCritic, SACActor,
                                                 SACCritic, flax_to_state,
                                                 state_to_flax)
from raytracer_tpu_torch.agents.ppo import PPOConfig, PPOTrainer, gae
from raytracer_tpu_torch.agents.sac import SACConfig, SACTrainer
from raytracer_tpu_torch.utils.metrics import episode_analytics

from test_torch_rl_env import make_envs
from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, MAX_BOUNCES = 32, 3
T = MAX_BOUNCES + 2


def flat(tree, prefix=""):
    """A flax tree as ``{"a/b/kernel": numpy}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def closure(jitted, name):
    """A local function the JAX trainer's jitted closure captured."""
    f = jitted.__wrapped__
    return f.__closure__[f.__code__.co_freevars.index(name)].cell_contents


def assert_state_close(module, tree, atol):
    want = flax_to_state(flat(tree))
    got = module.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol,
                                   rtol=0, err_msg=k)


def obs_batch(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 18)).astype(
        np.float32)


@pytest.mark.parametrize("which", ["ppo", "sac_actor", "sac_critic"])
def test_networks_match_flax(which):
    """flax-initialised weights carried across: outputs within 1e-6 (the
    products' sum order differs), and back to the same flax arrays."""
    x = obs_batch(16, 1)
    a = np.random.default_rng(2).uniform(-1, 1, (16, 2)).astype(np.float32)
    with jax.enable_x64(False):
        if which == "ppo":
            net, mod = jax_networks.PPOActorCritic(hidden=(32, 24)), \
                PPOActorCritic(hidden=(32, 24))
            args = (x,)
        elif which == "sac_actor":
            net, mod = jax_networks.SACActor(hidden=(32, 24)), \
                SACActor(hidden=(32, 24))
            args = (x,)
        else:
            net, mod = jax_networks.SACCritic(hidden=(32, 24)), \
                SACCritic(hidden=(32, 24))
            args = (x, a)
        params = net.init(jax.random.key(0), *args)["params"]
        want = net.apply({"params": params}, *args)
    mod.load_state_dict(flax_to_state(flat(params)))
    got = mod(*(torch.from_numpy(v) for v in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-6, rtol=0)
    back = state_to_flax(mod)
    for k, v in flat(params).items():
        np.testing.assert_array_equal(back[k], v)


@pytest.fixture(scope="module")
def ppo_pair():
    """The JAX PPO trainer and the port's with its weights, on the same
    env (64x48, 3 bounces, 32 lanes)."""
    cfg = dict(batch_envs=B, epochs=1, minibatches=2, ent_coef=0.01,
               hidden=(32, 32))
    with jax.enable_x64(False):
        je, te = make_envs("rl", max_bounces=MAX_BOUNCES)
        jt = JaxPPO(je, JaxPPOConfig(**cfg), seed=0)
    pt = PPOTrainer(te, PPOConfig(**cfg))
    pt.load_state(flax_to_state(flat(jt.params)))
    return jt, pt


def jax_rollout_draws(key, w, h):
    """``(pixel [B, 2], noise [T, B, 2])`` as JAX's rollout draws them
    (64-bit mode off)."""
    with jax.enable_x64(False):
        return _jax_rollout_draws(key, w, h)


def _jax_rollout_draws(key, w, h):
    k_reset, k_steps = jax.random.split(key)
    kx, ky = jax.random.split(k_reset)
    pix = np.stack([jax.random.randint(kx, (B,), 0, w),
                    jax.random.randint(ky, (B,), 0, h)], -1)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 2), jnp.float32))
                      for k in jax.random.split(k_steps, T)])
    return torch.from_numpy(pix), torch.from_numpy(noise)


def test_ppo_rollout_gae_and_update_match_jax(ppo_pair):
    """One rollout on JAX's draws (observations within 1e-4, rewards
    within 1e-6 of JAX's jitted rollout, the activity mask equal), GAE on
    it bit for bit, then one update (an epoch of 2 minibatches, optax's
    clip then Adam) on JAX's records and permutation: the loss within
    1e-6 and every parameter within 1e-6 of JAX's."""
    jt, pt = ppo_pair
    key = jax.random.key(7)
    with jax.enable_x64(False):
        jrecs, jlast, jtot = jt._rollout(jt.params, key)
    recs, last, tot = pt.rollout(*jax_rollout_draws(key, 64, 48))
    atol = {"obs": 1e-4, "u": 1e-5, "logp": 1e-5, "value": 1e-5,
            "reward": 1e-6}
    for (name, tol), w, g in zip(atol.items(), jrecs, recs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(recs[5].numpy(), np.asarray(jrecs[5]))
    np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), atol=1e-6)

    jrecs = tuple(np.array(x) for x in jrecs)
    with jax.enable_x64(False):
        jgae = closure(jt._update, "gae")
        want = jgae(*(jnp.asarray(jrecs[i]) for i in (4, 3)),
                    jnp.asarray(jrecs[5], jnp.float32), jnp.asarray(jlast))
        params, _, loss = jt._update(jt.params, jt.opt_state, jrecs, jlast,
                                     jax.random.key(9))
        perms = np.stack([np.asarray(jax.random.permutation(k, T * B))
                          for k in jax.random.split(jax.random.key(9), 1)])
    trecs = tuple(torch.from_numpy(x) for x in jrecs)
    tlast = torch.from_numpy(np.array(jlast))
    got = gae(trecs[4], trecs[3], trecs[5].float(), tlast, 0.99, 0.95)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tl = pt.update(trecs, tlast, torch.from_numpy(perms))
    assert abs(tl - float(loss)) <= 1e-6
    assert_state_close(pt.net, params, 1e-6)


def test_ppo_loss_and_gradient_match_jax(ppo_pair):
    """JAX's ``loss_fn`` and its gradient on one minibatch: the loss and
    its two terms within 1e-6, each gradient leaf within 1e-5 of its
    largest element."""
    jt, pt = ppo_pair
    rng = np.random.default_rng(4)
    n = 64
    batch = (obs_batch(n, 3), rng.normal(size=(n, 2)).astype(np.float32),
             rng.normal(size=n).astype(np.float32) - 2.0,
             rng.normal(size=n).astype(np.float32),
             rng.normal(size=n).astype(np.float32),
             (rng.random(n) < 0.8).astype(np.float32))
    with jax.enable_x64(False):
        loss_fn = closure(jt._update, "loss_fn")
        (jl, (jpg, jvf)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jt.params, tuple(jnp.asarray(b) for b in batch))
    pt.load_state(flax_to_state(flat(jt.params)))
    pt.net.zero_grad()
    tl, (tpg, tvf) = pt.loss(tuple(torch.from_numpy(b) for b in batch))
    tl.backward()
    for g, w in ((tl, jl), (tpg, jpg), (tvf, jvf)):
        assert abs(float(g.detach()) - float(w)) <= 1e-6
    want = flax_to_state(flat(grads))
    for name, p in pt.net.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, (name, err)


def test_clip_by_global_norm_is_optax():
    """Scaled by max_norm / norm only at or above max_norm."""
    import optax
    from raytracer_tpu_torch.agents.ppo import clip_by_global_norm_
    for scale in (0.1, 10.0):
        g = [np.random.default_rng(s).normal(size=sh).astype(np.float32)
             * scale for s, sh in ((0, (3, 4)), (1, (5,)))]
        with jax.enable_x64(False):
            want, _ = optax.clip_by_global_norm(0.5).update(
                [jnp.asarray(x) for x in g], None)
        ps = [torch.nn.Parameter(torch.zeros(x.shape)) for x in g]
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x.copy())
        clip_by_global_norm_(ps, 0.5)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=2e-7, atol=0)


@pytest.fixture(scope="module")
def sac_pair():
    cfg = dict(batch_envs=B, learning_starts=64, batch_size=64,
               buffer_size=1000, hidden=(32, 32))
    with jax.enable_x64(False):
        je, te = make_envs("rl", max_bounces=MAX_BOUNCES)
        jt = JaxSAC(je, JaxSACConfig(**cfg), seed=0)
    return jt, te, cfg


def flax_arrays(tree):
    """A flax tree as state-dict keys, kernels transposed, dtype kept."""
    return {k.replace("/", ".").replace("kernel", "weight"):
            (v.T if k.endswith("kernel") else v)
            for k, v in flat(tree).items()}


def sac_update_both(sac_pair, weighted, dtype):
    """One SAC update in both packages on the same weights (the JAX
    trainer's initial ones), batch and noise, in ``dtype``: ``(JAX's
    outputs, the port's trainer, its losses)``."""
    jt, te, cfg = sac_pair
    x64 = dtype == np.float64
    rng = np.random.default_rng(5)
    n = 64
    batch = [obs_batch(n, 6), rng.uniform(0, 1.5, (n, 2)).astype(
        np.float32), rng.normal(size=n).astype(np.float32),
        obs_batch(n, 7), (rng.random(n) < 0.3).astype(np.float32)]
    if weighted:
        batch.append((rng.random(n) < 0.75).astype(np.float32))
    batch = [b.astype(dtype) for b in batch]
    key = jax.random.key(11)
    with jax.enable_x64(x64):
        def cast(t):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
        trees = [cast(t) for t in (jt.actor_params, jt.critic_params,
                                   jt.target_critic_params)]
        log_alpha = jnp.zeros((), dtype)
        opts = (jt.actor_tx.init(trees[0]), jt.critic_tx.init(trees[1]),
                jt.alpha_tx.init(log_alpha))
        k1, k2 = jax.random.split(key)
        noise = [torch.from_numpy(np.array(jax.random.normal(
            k, (n, 2), dtype))) for k in (k1, k2)]
        upd = jt._build_update(weighted=True) if weighted else jt._update
        out = upd(*trees, log_alpha, opts,
                  tuple(jnp.asarray(b) for b in batch), key)
    pt = SACTrainer(te, SACConfig(**cfg))
    pt.load_states(*(flax_to_state(flat(t)) for t in trees))
    if x64:
        for m in (pt.actor, pt.critic, pt.target_critic):
            m.double()
        pt.log_alpha.data = pt.log_alpha.data.double()
        pt.mid, pt.scale = pt.mid.double(), pt.scale.double()
    cl, al = pt.update(tuple(torch.from_numpy(b) for b in batch), *noise,
                       weighted=weighted)
    return out, pt, (float(cl), float(al))


def param_errors(module, tree):
    """Per-element ``|port - JAX|`` of every parameter, flat, float64."""
    want = flax_arrays(tree)
    got = module.state_dict()
    assert set(got) == set(want)
    return np.concatenate([np.abs(got[k].double().numpy().ravel()
                                  - np.asarray(w, np.float64).ravel())
                           for k, w in want.items()])


@pytest.mark.parametrize("weighted", [False, True])
def test_sac_update_matches_jax_float64(sac_pair, weighted):
    """One update (critic, actor and temperature Adam steps, Polyak
    target), both packages in float64: losses within 1e-9, every parameter
    and ``log_alpha`` within 1e-11 of JAX's."""
    (ja, jc, jtg, jla, _, jcl, jal), pt, (cl, al) = sac_update_both(
        sac_pair, weighted, np.float64)
    assert abs(cl - float(jcl)) <= 1e-9 and abs(al - float(jal)) <= 1e-9
    for module, tree in ((pt.actor, ja), (pt.critic, jc),
                         (pt.target_critic, jtg)):
        assert param_errors(module, tree).max() <= 1e-11
    assert abs(float(pt.log_alpha) - float(jla)) <= 1e-11


@pytest.mark.parametrize("weighted", [False, True])
def test_sac_update_float32_within_bounds(sac_pair, weighted):
    """The same update in float32.  The squash's ``log(scale (1 - t^2) +
    1e-6)`` turns an ulp of ``tanh`` near ±1 (XLA's float32 tanh is a
    rational approximation, off PyTorch's by an ulp on most arguments)
    into up to ~1e-2 of a sample's log-density, and Adam's first step is
    ``lr * sign(g)``: the critic loss within 1e-3 of JAX's relative, the
    actor loss within 1e-2; every parameter within 2 lr of JAX's and at
    most 1% of them off by more than 1e-6; ``log_alpha`` within 1e-8."""
    (ja, jc, jtg, jla, _, jcl, jal), pt, (cl, al) = sac_update_both(
        sac_pair, weighted, np.float32)
    assert abs(cl - float(jcl)) <= 1e-3 * abs(float(jcl))
    assert abs(al - float(jal)) <= 1e-2
    lr = pt.cfg.learning_rate
    for module, tree in ((pt.actor, ja), (pt.critic, jc),
                         (pt.target_critic, jtg)):
        err = param_errors(module, tree)
        assert err.max() <= 2 * lr * (1 + 1e-3)
        assert (err > 1e-6).mean() <= 0.01
    assert abs(float(pt.log_alpha) - float(jla)) <= 1e-8


def test_sac_sample_action_matches_jax(sac_pair):
    """The squashed action and ``predict`` within 2e-6 of JAX's."""
    jt, te, cfg = sac_pair
    x = obs_batch(16, 8)
    with jax.enable_x64(False):
        noise = jax.random.normal(jax.random.key(3), (16, 2), jnp.float32)
        wa = jt.actor.apply({"params": jt.actor_params}, jnp.asarray(x))
        mean, log_std = wa
        u = mean + jnp.exp(log_std) * noise
        t = jnp.tanh(u)
        a_want = jt.mid + jt.scale * t
    pt = SACTrainer(te, SACConfig(**cfg))
    pt.load_states(flax_to_state(flat(jt.actor_params)),
                   flax_to_state(flat(jt.critic_params)))
    a, logp = pt.sample_action(torch.from_numpy(x),
                               torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_want),
                               atol=2e-6)
    assert torch.isfinite(logp).all()
    np.testing.assert_allclose(pt.predict(x[:1]), np.asarray(jt.predict(
        x[:1])), atol=2e-6)


def test_tabular_q_matches_jax(monkeypatch):
    """Tabular Q on JAX's reset pixels and the same numpy ε-greedy draws:
    the Q table within 1e-6 and the episode rewards within 1e-5 (JAX's
    jitted env multiplies by 1/765 in the reward)."""
    cfg = dict(batch_envs=16, max_steps=6)
    with jax.enable_x64(False):
        je, te = make_envs("rl", max_bounces=MAX_BOUNCES)
        jq = JaxQ(je, JaxQConfig(**cfg), seed=3)
        want_hist = jq.train(num_episodes=48)
        want_test = jq.test(num_episodes=16)
        key = jax.random.key(3)
        pixels = []
        for n in (16, 16, 16, 16):
            key, kr = jax.random.split(key)
            kx, ky = jax.random.split(kr)
            pixels.append(np.stack([jax.random.randint(kx, (n,), 0, 64),
                                    jax.random.randint(ky, (n,), 0, 48)],
                                   -1))
    tq = tabular_q.TabularQTrainer(te, tabular_q.TabularQConfig(**cfg),
                                   seed=3)
    reset = te.reset
    monkeypatch.setattr(te, "reset", lambda batch, pixel=None, **kw: reset(
        batch, pixel=pixels.pop(0)))
    got_hist = tq.train(num_episodes=48)
    np.testing.assert_allclose(got_hist, want_hist, atol=1e-5)
    np.testing.assert_allclose(tq.q, jq.q, atol=1e-6)
    assert abs(tq.test(num_episodes=16) - want_test) <= 1e-5
    assert tq.epsilon == jq.epsilon


def test_trainers_run_and_report_jax_schema():
    """PPO ``train``/``train_on_device`` and SAC ``train``/
    ``train_on_device`` at a tiny size: the JAX package's returned keys,
    finite losses, actions inside the box."""
    _, env = make_envs("rl", max_bounces=MAX_BOUNCES)
    ppo = PPOTrainer(env, PPOConfig(batch_envs=16, epochs=1, minibatches=2))
    out = ppo.train(16 * T * 2)
    assert set(out) == {"iterations", "final_loss", "mean_episode_reward"}
    out = ppo.train_on_device(16 * T * 3, iters_per_dispatch=2)
    assert out["iterations"] == 4 and out["dispatches"] == 2
    assert out["backend"] == "cpu" and np.isfinite(out["final_loss"])
    a = ppo.predict(np.zeros(18, np.float32))
    assert a.shape == (2,) and 0 <= a[0] <= np.pi / 2
    sac = SACTrainer(env, SACConfig(batch_envs=16, learning_starts=32,
                                    batch_size=32, buffer_size=2000,
                                    hidden=(32, 32)))
    out = sac.train(200, updates_per_rollout=2)
    assert out["total_steps"] >= 200 and np.isfinite(out["critic_loss"])
    out = sac.train_on_device(16 * T * 2, iters_per_dispatch=2,
                              updates_per_rollout=2)
    assert {"total_steps", "buffer_capacity", "critic_loss", "actor_loss",
            "mean_episode_reward", "wall_seconds", "dispatches",
            "backend", "device"} == set(out)
    assert out["buffer_capacity"] % (16 * T) == 0
    assert np.isfinite(out["critic_loss"]) and out["critic_loss"] != 0.0
    a = sac.predict(torch.zeros((3, 18)))
    assert a.shape == (3, 2) and bool((a >= 0).all())


def test_analytics_and_episode_rows():
    """``analyze_agent_behavior``'s keys and counts, the canonical-pixel
    probe, 3-D paths, and ``episode_analytics`` equal to JAX's rows."""
    from raytracer_tpu.utils.metrics import episode_analytics as jax_rows
    _, env = make_envs("rl", max_bounces=MAX_BOUNCES)
    beh = analytics.analyze_agent_behavior(env, None, episodes=32)
    assert beh["episodes"] == 32
    assert sum(beh["termination_reasons"].values()) == 32
    assert sum(beh["hit_frequency_by_id"].values()) == 32
    probe = analytics.canonical_pixel_policy_probe(
        env, lambda o: torch.full((o.shape[0], 2), 0.5))
    assert len(probe) == 5 and probe["(32, 24)"]["theta"] == 0.5
    paths = analytics.collect_3d_paths(env, None, episodes=8)
    assert all(p.shape[1] == 3 and len(p) > 1 for p in paths)
    log = analytics.RewardLogger()
    log.log_batch([1.0, 2.0], [1, 2])
    assert log.episode_lengths == [1, 2]
    args = (None, [1.5, -0.1], [2, 0], [99, -1], ["terminal", "ray_escaped"])
    assert episode_analytics(*args) == jax_rows(*args)


def test_action_bins_match_jax():
    from raytracer_tpu.agents import tabular_q as jax_q
    for idx in range(64):
        np.testing.assert_array_equal(
            tabular_q.continuous_from_discrete(idx),
            jax_q.continuous_from_discrete(idx))
        a = tabular_q.continuous_from_discrete(idx)
        assert tabular_q.discretize_action(a) == jax_q.discretize_action(a)
