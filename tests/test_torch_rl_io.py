"""The RL agents' files across the two packages: the shipped policies
(byte-equal copies in raytracer_tpu_torch/agents/shipped/), ``.npz`` and
pickle both ways, the SB3 ``.zip`` import, and the port's own resume file
(utils/train_ckpt.py)."""
import io
import json
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.agents.ppo import PPOConfig as JaxPPOConfig
from raytracer_tpu.agents.ppo import PPOTrainer as JaxPPO
from raytracer_tpu.agents.sac import SACConfig as JaxSACConfig
from raytracer_tpu.agents.sac import SACTrainer as JaxSAC
from raytracer_tpu_torch.agents import SHIPPED_DIR
from raytracer_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from raytracer_tpu_torch.agents.sac import SACConfig, SACTrainer
from raytracer_tpu_torch.compare.workbench import load_policy
from raytracer_tpu_torch.utils import train_ckpt
from raytracer_tpu_torch.utils.sb3_import import load_sb3_zip

from test_torch_rl_env import make_envs
from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODELS = Path(__file__).parents[1] / "models"
OBS = np.random.default_rng(0).normal(size=(32, 18)).astype(np.float32)
# Predictions across the packages: the products' sum order differs.
ATOL = 1e-5


def envs():
    with jax.enable_x64(False):
        return make_envs("rl", max_bounces=3)


@pytest.mark.parametrize("name", ["ppo_raytracer.npz", "sac_raytracer.npz"])
def test_shipped_copies_equal_models(name):
    if not (MODELS / name).exists():
        pytest.skip("models/ is not in this checkout")
    assert (SHIPPED_DIR / name).read_bytes() == (MODELS / name).read_bytes()


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_port_reads_shipped_policy_as_jax(algo):
    """The shipped policy (PPO 128x128, SAC 256x256): the port's
    ``predict`` within 1e-5 of JAX's on the same observations."""
    je, te = envs()
    path = SHIPPED_DIR / f"{algo}_raytracer.npz"
    with jax.enable_x64(False):
        if algo == "ppo":
            jt = JaxPPO(je, JaxPPOConfig(hidden=(128, 128)), seed=0)
        else:
            jt = JaxSAC(je, JaxSACConfig(), seed=0)
        jt.load(str(path))
        want = np.asarray(jt.predict(OBS))
    tr = load_policy(path, te, algo=algo)
    assert tr.cfg.hidden == ((128, 128) if algo == "ppo" else (256, 256))
    np.testing.assert_allclose(tr.predict(OBS), want, atol=ATOL, rtol=0)
    got = tr.predict(torch.from_numpy(OBS))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("suffix", [".npz", ".pkl"])
@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_files_both_ways(tmp_path, algo, suffix):
    """JAX's ``load`` reads the port's file and the port reads JAX's: the
    same ``predict`` within 1e-5, and the weights exactly."""
    je, te = envs()
    if algo == "ppo":
        port = PPOTrainer(te, PPOConfig(hidden=(32, 16)), seed=3)
        with jax.enable_x64(False):
            jt = JaxPPO(je, JaxPPOConfig(hidden=(32, 16)), seed=4)
    else:
        port = SACTrainer(te, SACConfig(hidden=(32, 16)), seed=3)
        with torch.no_grad():
            port.log_alpha.fill_(-0.25)
        with jax.enable_x64(False):
            jt = JaxSAC(je, JaxSACConfig(hidden=(32, 16)), seed=4)
    mine, theirs = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    port.save(mine)
    with jax.enable_x64(False):
        jt.save(str(theirs))
        jt.load(str(mine))
        want_mine = np.asarray(jt.predict(OBS))
    np.testing.assert_allclose(port.predict(OBS), want_mine, atol=ATOL)
    if algo == "sac":
        assert float(jt.log_alpha) == -0.25
    other = type(port)(te, seed=9)
    other.load(theirs)
    with jax.enable_x64(False):
        jt.load(str(theirs))
        want = np.asarray(jt.predict(OBS))
    np.testing.assert_allclose(other.predict(OBS), want, atol=ATOL)
    if suffix == ".npz":
        with np.load(mine) as a, np.load(theirs) as b:
            assert sorted(a.files) == sorted(b.files)
            cfg = json.loads(bytes(a["__config__"]).decode())
            assert cfg["hidden"] == [32, 16]


def _sb3_zip(path, algo, seed=0):
    """An SB3-layout archive: ``policy.pth`` (a torch state dict with
    SB3's names) and the ``data`` JSON with the action space's reprs."""
    g = torch.Generator().manual_seed(seed)

    def lin(sd, name, i, o):
        sd[f"{name}.weight"] = torch.randn((o, i), generator=g) * 0.3
        sd[f"{name}.bias"] = torch.randn((o,), generator=g) * 0.1

    sd = {}
    if algo == "sac":
        lin(sd, "actor.latent_pi.0", 18, 24)
        lin(sd, "actor.latent_pi.2", 24, 24)
        lin(sd, "actor.mu", 24, 2)
        lin(sd, "actor.log_std", 24, 2)
        for prefix in ("critic", "critic_target"):
            for q in (0, 1):
                lin(sd, f"{prefix}.qf{q}.0", 20, 24)
                lin(sd, f"{prefix}.qf{q}.2", 24, 24)
                lin(sd, f"{prefix}.qf{q}.4", 24, 1)
    else:
        for net in ("policy_net", "value_net"):
            lin(sd, f"mlp_extractor.{net}.0", 18, 24)
            lin(sd, f"mlp_extractor.{net}.2", 24, 24)
        lin(sd, "action_net", 24, 2)
        lin(sd, "value_net", 24, 1)
        sd["log_std"] = torch.zeros(2)
    buf = io.BytesIO()
    torch.save(sd, buf)
    data = {"action_space": {"low": "[0. 0.]",
                             "high": "[1.5707964 6.2831855]"}}
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("policy.pth", buf.getvalue())
        z.writestr("data", json.dumps(data))
        z.writestr("_stable_baselines3_version", "2.0.0")
    return {k: v.numpy() for k, v in sd.items()}


def _lin(sd, name, x):
    return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_sb3_zip_import(tmp_path, algo):
    """SB3's deterministic predict (the numpy oracle of
    tests/test_sb3_import.py) and JAX's ``load_sb3``: within 1e-5."""
    path = tmp_path / f"{algo}.zip"
    sd = _sb3_zip(path, algo)
    je, te = envs()
    tr = load_policy(path, te)                   # algo sniffed from keys
    assert isinstance(tr, SACTrainer if algo == "sac" else PPOTrainer)
    low = np.array([0.0, 0.0], np.float32)
    high = np.array([np.pi / 2, 2 * np.pi], np.float32)
    if algo == "sac":
        relu = lambda v: np.maximum(v, 0.0)      # noqa: E731
        h = relu(_lin(sd, "actor.latent_pi.2",
                      relu(_lin(sd, "actor.latent_pi.0", OBS))))
        want = low + 0.5 * (np.tanh(_lin(sd, "actor.mu", h)) + 1.0) \
            * (high - low)
        act = np.random.default_rng(1).uniform(-1, 1, (32, 2)).astype(
            np.float32)
        q = tr.critic(torch.from_numpy(OBS), torch.from_numpy(act))
        x = np.concatenate([OBS, act], -1)
        for i, got in enumerate(q):
            hq = relu(_lin(sd, f"critic.qf{i}.2",
                           relu(_lin(sd, f"critic.qf{i}.0", x))))
            np.testing.assert_allclose(got.detach().numpy(),
                                       _lin(sd, f"critic.qf{i}.4", hq)[:, 0],
                                       atol=1e-4)
        tq = tr.target_critic(torch.from_numpy(OBS), torch.from_numpy(act))
        assert torch.isfinite(tq[0]).all()
    else:
        h = np.tanh(_lin(sd, "mlp_extractor.policy_net.2",
                         np.tanh(_lin(sd, "mlp_extractor.policy_net.0",
                                      OBS))))
        want = np.clip(_lin(sd, "action_net", h), low, high)
    np.testing.assert_allclose(tr.predict(OBS), want, atol=ATOL)
    np.testing.assert_allclose(tr.high.numpy(), high)
    with jax.enable_x64(False):
        jcfg = (JaxSACConfig if algo == "sac" else JaxPPOConfig)(
            hidden=(24, 24))
        jt = (JaxSAC if algo == "sac" else JaxPPO)(je, jcfg, seed=0)
        jt.load_sb3(str(path))
        np.testing.assert_allclose(tr.predict(OBS), np.asarray(
            jt.predict(OBS)), atol=ATOL)
    assert load_sb3_zip(path)["version"] == "2.0.0"
    with zipfile.ZipFile(tmp_path / "bad.zip", "w") as z:
        z.writestr("data", "{}")
    with pytest.raises(ValueError, match="not an SB3 archive"):
        load_sb3_zip(tmp_path / "bad.zip")


def test_train_ckpt_resume(tmp_path):
    """The resume file holds the weights, the optimisers' state and the
    counters: a resumed trainer predicts as the saved one, its Adam state
    equal, and trains on."""
    _, te = envs()
    ppo = PPOTrainer(te, PPOConfig(batch_envs=16, epochs=1, minibatches=2))
    ppo.train(200)
    train_ckpt.save_train_state(tmp_path / "ppo.pt", train_ckpt.ppo_state(ppo))
    ppo2 = PPOTrainer(te, PPOConfig(batch_envs=16, epochs=1, minibatches=2),
                      seed=9)
    train_ckpt.resume_ppo(ppo2, tmp_path / "ppo.pt")
    np.testing.assert_array_equal(ppo2.predict(OBS), ppo.predict(OBS))
    assert ppo2.episode_rewards == ppo.episode_rewards
    s1, s2 = ppo.opt.state_dict()["state"], ppo2.opt.state_dict()["state"]
    assert all(torch.equal(s1[k]["exp_avg"], s2[k]["exp_avg"]) for k in s1)
    ppo2.train(200)

    cfg = SACConfig(batch_envs=8, learning_starts=32, batch_size=32,
                    buffer_size=1000, hidden=(32, 32))
    sac = SACTrainer(te, cfg)
    sac.train(120, updates_per_rollout=1)
    train_ckpt.save_train_state(tmp_path / "sac.pt", train_ckpt.sac_state(sac))
    sac2 = SACTrainer(te, cfg, seed=7)
    train_ckpt.resume_sac(sac2, tmp_path / "sac.pt")
    np.testing.assert_array_equal(sac2.predict(OBS), sac.predict(OBS))
    assert sac2.total_steps == sac.total_steps
    assert torch.equal(sac2.log_alpha, sac.log_alpha)
    for a, b in zip(sac.target_critic.parameters(),
                    sac2.target_critic.parameters()):
        assert torch.equal(a, b)
    sac2.train(sac2.total_steps + 60, updates_per_rollout=1)
