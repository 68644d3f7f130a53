"""The port's ``interactive`` command (raytracer_tpu_torch/cli.py::
cmd_interactive) against the JAX CLI's.

The menus are compared by running both packages' ``cmd_interactive`` on
the same scripted input with the same recording stand-ins for the
trainers, the evaluations and the other commands: the printed lines, the
prompts and the calls must be equal, except option 4's integration
example, which is the port's own.  Then every option and training mode
runs for real in the port with ``--device cpu`` at tiny sizes.

Two JAX defects show on this path.  Its SAC has no ``get_parameters``, so
mode 2 (the curriculum) raises after phase 1; and options 2 and 5 hand the
trainer that ``load_policy`` returns to ``evaluate_policy``, which calls
it, so a found model raises ``TypeError``.  The port carries SAC's
parameters and passes ``trainer.predict``."""
import argparse
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import raytracer_tpu.agents.sac as jax_sac
import raytracer_tpu.cli as jax_cli
import raytracer_tpu.compare.workbench as jax_workbench
import raytracer_tpu_torch.agents.sac as port_sac
import raytracer_tpu_torch.compare.workbench as port_workbench
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.agents import SHIPPED_DIR

from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIPPED_PPO = str(SHIPPED_DIR / "ppo_raytracer.npz")


def scripted(answers, prompts):
    """An ``input`` that records its prompts and answers in turn, then
    raises ``EOFError``."""
    it = iter(answers)

    def input_fn(prompt):
        prompts.append(prompt)
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None
    return input_fn


def env_desc(env):
    if isinstance(env, str):
        return env
    return (type(env).__name__, env.image_width, env.image_height, env.fov,
            env.max_bounces, env.variant, int(env.scene.num_spheres))


def install_recorders(mp, cli_mod, sac_mod, wb_mod, log):
    class Trainer:
        def __init__(self, env, config=None, seed=0):
            self.env = env
            log.append(("SACTrainer", env_desc(env),
                        type(config).__name__ if config else None, seed))

        def load(self, path):
            log.append(("load", str(path)))

        def train(self, steps):
            log.append(("train", steps))
            return {"trained": steps}

        def save(self, path):
            log.append(("save", path))

        def predict(self, obs, deterministic=True):
            return np.zeros((len(obs), 2), np.float32)

        def get_parameters(self):
            return {"phase_of": env_desc(self.env)}

        def set_parameters(self, params):
            log.append(("set_parameters", params))

    class Policy(Trainer):
        def __call__(self, obs):
            return self.predict(obs)

    def evaluate_policy(env, policy, episodes=50, **kw):
        log.append(("evaluate_policy", env_desc(env), callable(policy),
                    episodes))
        return {"episodes": episodes}

    def compare_rl_vs_random(env, policy, episodes=100, **kw):
        a = np.asarray(policy(np.zeros((3, 18), np.float32)))
        log.append(("compare_rl_vs_random", env_desc(env), a.shape,
                    episodes))
        return {"episodes": episodes}

    def load_policy(path, env, algo=None):
        log.append(("load_policy", str(path), env_desc(env)))
        return Policy(env)

    mp.setattr(sac_mod, "SACTrainer", Trainer)
    mp.setattr(wb_mod, "evaluate_policy", evaluate_policy)
    mp.setattr(wb_mod, "compare_rl_vs_random", compare_rl_vs_random)
    mp.setattr(wb_mod, "load_policy", load_policy)
    mp.setattr(wb_mod, "check_model_exists",
               lambda name, base=".": Path(f"{name}.npz")
               if name.startswith("found") else None)
    mp.setattr(cli_mod, "_make_rl_env", lambda *a, **k: "training_scene_v1")
    mp.setattr(cli_mod, "cmd_demo",
               lambda args: log.append(("demo", args.seed)))
    mp.setattr(cli_mod, "cmd_rl_pipeline",
               lambda args: log.append(("rl_pipeline", args.timesteps,
                                        args.out, args.seed)))


def run_menu(cli_mod, sac_mod, wb_mod, answers, capsys, **ns):
    log, prompts = [], []
    with pytest.MonkeyPatch.context() as mp:
        install_recorders(mp, cli_mod, sac_mod, wb_mod, log)
        args = argparse.Namespace(seed=3, **ns)
        cli_mod.cmd_interactive(args, input_fn=scripted(answers, prompts))
    return capsys.readouterr().out.splitlines(), prompts, log


MENUS = {
    "train standard": ["1", "1", "8", "m"],
    "train curriculum": ["1", "2", "9", "c"],
    "train continue found": ["1", "3", "8", "found_m"],
    "train continue fresh": ["1", "3", "8", "m"],
    "evaluate found": ["2", "found_x"],
    "evaluate missing": ["2", "missing"],
    "demonstrate": ["3"],
    "integration": ["4"],
    "benchmark random": ["5", ""],
    "benchmark found": ["5", "found_p"],
    "pipeline": ["6", "12"],
    "bad option": ["x", "1", "8", "m"],
    "bad mode": ["1", "y", "8", "m"],
    "defaults": ["", "", "", ""],
    "eof": [],
    "option 0": ["0", "12"],
}


@pytest.mark.parametrize("answers", MENUS.values(), ids=MENUS.keys())
def test_menu_matches_jax(answers, capsys):
    """The same lines, prompts and calls as the JAX CLI's; option 4's
    example is the port's own and imports ``raytracer_tpu_torch`` only."""
    want = run_menu(jax_cli, jax_sac, jax_workbench, answers, capsys)
    got = run_menu(cli, port_sac, port_workbench, answers, capsys,
                   device="cpu")
    if answers == ["4"]:
        cut = want[0].index("INTEGRATION EXAMPLE") + 2
        assert got[0][:cut] == want[0][:cut]
        example = "\n".join(got[0][cut:])
        assert example.strip() == cli.INTEGRATION_EXAMPLE.strip()
        assert "raytracer_tpu." not in example
        assert "raytracer_tpu_torch" in example
        assert got[1:] == want[1:]
    else:
        assert got == want


def test_integration_example_compiles_and_its_names_exist():
    import ast
    import importlib
    tree = ast.parse(cli.INTEGRATION_EXAMPLE)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = importlib.import_module(node.module)
            for alias in node.names:
                assert hasattr(mod, alias.name), (node.module, alias.name)
    assert "docs/INTEGRATION.md" in cli.INTEGRATION_EXAMPLE


REAL = {
    "1 mode 1": (["1", "1", "8", "m"], ["m.pkl"]),
    "1 mode 2": (["1", "2", "9", "c"], ["c.pkl"]),
    "1 mode 3": (["1", "3", "8", "m"], ["m.pkl"]),
    "2": (["2", SHIPPED_PPO], []),
    "3": (["3"], []),
    "4": (["4"], []),
    "5 random": (["5", ""], []),
    "5 policy": (["5", SHIPPED_PPO], []),
    "6": (["6", "48"], ["raytracer_final.pkl",
                        "raytracer_final_benchmark.json"]),
}


@pytest.mark.parametrize("case", REAL.keys())
def test_every_option_runs_on_cpu(case, tmp_path, monkeypatch, capsys):
    """Each option and training mode end to end in the port with
    ``--device cpu`` at tiny sizes; the files it writes appear."""
    answers, files = REAL[case]
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(seed=0, device="cpu")
    prompts = []
    if case == "1 mode 3":          # a model to continue from
        cli.cmd_interactive(args, input_fn=scripted(["1", "1", "8", "m"],
                                                    []))
        capsys.readouterr()
    cli.cmd_interactive(args, input_fn=scripted(answers, prompts))
    out = capsys.readouterr().out
    for f in files:
        assert (tmp_path / f).exists(), f
    if case.startswith("1") or case == "2":
        ev = json.loads(out.strip().splitlines()[-1])
        assert ev["episodes"] == 20 and np.isfinite(ev["avg_reward"])
    if case == "1 mode 3":
        assert "Loaded existing model: m.pkl" in out
    if case == "3":
        assert "total reward" in out
    if case == "4":
        assert cli.INTEGRATION_EXAMPLE in out
    if case.startswith("5"):
        assert '"rays_per_light_hit"' in out
    if case == "6":
        bench = json.loads((tmp_path / files[1]).read_text())
        assert bench["rl"]["episodes"] == 100


def test_without_a_card_it_asks_for_one(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["interactive"])


def test_jax_defects_on_this_path(tmp_path, monkeypatch, capsys):
    """JAX's option 2 on a found model raises ``TypeError`` (the trainer is
    called as a policy); its mode 2 raises ``AttributeError`` after phase 1
    (its SAC has no ``get_parameters``).  The port's complete (above)."""
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(seed=0)
    with jax.enable_x64(False):
        with pytest.raises(TypeError, match="not callable"):
            jax_cli.cmd_interactive(args, input_fn=scripted(
                ["2", SHIPPED_PPO], []))
        monkeypatch.setattr(jax_sac.SACTrainer, "train",
                            lambda self, steps: {"steps": steps})
        with pytest.raises(AttributeError, match="get_parameters"):
            jax_cli.cmd_interactive(args, input_fn=scripted(
                ["1", "2", "9", "c"], []))
