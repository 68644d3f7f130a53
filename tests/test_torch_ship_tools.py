"""The port's recipe tools (raytracer_tpu_torch/tools/ship_models.py and
ship_rl.py) against the JAX package's scripts.

* Each ``ship_models`` subcommand parses as ``scripts/ship_models.py``'s
  (loaded by path: it imports only the standard library at module
  level), minus ``--tpu``, plus ``--device``; its output paths move from
  ``models/`` and ``/tmp`` to ``build/ship/`` (the readers' defaults with
  them).
* ``train-*``'s chunk schedule (scene counts, ``guide_prob``,
  ``WALL_FRAC``, the config, the saved path and the held-out test) equals
  the script's, through a recording trainer patched into both packages'
  ``fb/trainer.py``.
* ``ppo-sweep``'s stage and candidate tables, ``ppo-ship``'s constants and
  the RL tools' arguments equal the scripts', read with ``ast``
  (importing ``scripts/ppo_train_to_win.py`` would point JAX's compilation
  cache at the home directory).
* Every subcommand runs on the CPU at a tiny size; the teacher that
  ``train-chandelier`` writes loads in JAX's ``load_fb``."""
import argparse
import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import raytracer_tpu.fb.trainer as jax_trainer
import raytracer_tpu_torch.fb.trainer as port_trainer
from raytracer_tpu.fb.config import FBConfig as JaxFBConfig
from raytracer_tpu.utils.checkpoint import load_fb as jax_load_fb
from raytracer_tpu_torch.fb.registry import STUDENTS_DIR
from raytracer_tpu_torch.tools import ship_models, ship_rl

from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "ship_models_script", SCRIPTS / "ship_models.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def jax_parser(monkeypatch):
    """The parser ``scripts/ship_models.py::main`` builds."""
    seen = []

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise _Stop

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Stop):
            jax_script().main([])
    return seen[0]


def subcommands(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def options(sub, drop):
    out = {}
    for a in sub._actions:
        if not a.option_strings or a.dest in ("help",) + drop:
            continue
        out[tuple(a.option_strings)] = dict(
            dest=a.dest, type=a.type, nargs=a.nargs, default=a.default,
            required=a.required, const=a.const, choices=a.choices,
            action=type(a).__name__)
    return out


def relocated(want, got):
    """A default that names a file under ``models/`` or ``/tmp`` in the
    script names one under ``build/ship/`` (or the deployed student's copy)
    in the port."""
    return (isinstance(want, str) and want.startswith(("models/", "/tmp/"))
            and (got.startswith("build/ship/")
                 or got == str(STUDENTS_DIR / Path(want).name)))


def test_ship_models_parsers_match_the_script(monkeypatch):
    want_subs = subcommands(jax_parser(monkeypatch))
    got_subs = subcommands(ship_models.build_parser())
    assert list(got_subs) == list(want_subs)
    moved = []
    for name in want_subs:
        want = options(want_subs[name], ("tpu",))
        got = options(got_subs[name], ("device",))
        assert got.keys() == want.keys(), name
        for k in want:
            w, g = dict(want[k]), dict(got[k])
            if w["default"] != g["default"]:
                assert relocated(w["default"], g["default"]), (name, k)
                moved.append((name, k[0]))
                w.pop("default"), g.pop("default")
            assert g == w, (name, k)
    assert ("heldout-chandelier", "--student") in moved
    for name in got_subs:
        assert {a.dest: a.default for a in got_subs[name]._actions
                }["device"] == "cuda"


def recording_trainers(log):
    class Agent:
        noise_scale = 0.5

        def save(self, path):
            log.append(("save", str(path)))

    def make(kind):
        class Recorder:
            WALL_FRAC = 0.35

            def __init__(self, num_training_scenes=100, config=None,
                         output_dir=None, seed=0, guide_prob=0.0,
                         resume_from=None, device=None):
                self.agent = Agent()
                self.num_training_scenes = num_training_scenes
                self.guide_prob = guide_prob
                log.append(("init", kind, num_training_scenes,
                            dataclasses.asdict(config) if config else None,
                            seed, guide_prob, resume_from))

            def run_training(self, **kw):
                log.append(("run_training", self.guide_prob, self.WALL_FRAC,
                            self.num_training_scenes, sorted(kw.items())))
                return {"performance_statistics": {"avg_hit_rate": 0.25},
                        "scene_type_performance": {"a": 1}}

            def test_on_chandelier(self, num_tests=200):
                log.append(("test_on_chandelier", num_tests))
                return {"n": num_tests}

            def test_on_complex(self, num_tests=200):
                log.append(("test_on_complex", num_tests))
                return {"n": num_tests}
        return Recorder
    return {k: make(k) for k in ("ChandelierOnlyTrainer",
                                 "RayTracedComplexTrainer",
                                 "MultiSceneFBTrainer")}


TRAIN_ARGVS = [
    ["train-chandelier", "--scenes", "8", "--steps", "3"],
    ["train-chandelier", "--scenes", "13", "--guide-prob", "0.7",
     "--wall-schedule", "0.1", "0.2", "0.3", "--seed", "4", "--z-dim", "16",
     "--f-hidden", "64", "--resume-from", "r.npz"],
    ["train-complex", "--scenes", "9", "--steps", "2", "--b-hidden", "32"],
    ["train-multi", "--scenes", "6", "--e-hidden", "48"],
]


@pytest.mark.parametrize("argv", TRAIN_ARGVS, ids=lambda a: " ".join(a))
def test_train_chunk_schedule_matches_the_script(argv, tmp_path,
                                                 monkeypatch, capsys):
    runs = []
    for mod, main, extra in (
            (jax_trainer, jax_script().main, ["--tpu"]),
            (port_trainer, ship_models.main, ["--device", "cpu"])):
        log = []
        with monkeypatch.context() as mp:
            for name, cls in recording_trainers(log).items():
                mp.setattr(mod, name, cls)
            main(argv + ["--out", str(tmp_path / "t.npz"), "--workdir",
                         str(tmp_path)] + extra)
        runs.append(log)
    assert runs[0] == runs[1]
    assert [e[0] for e in runs[1]].count("run_training") == 3
    out = capsys.readouterr().out
    if argv[0] == "train-chandelier":
        assert "[train-chandelier]" in out and "wall_frac" in out


def script_ast(name):
    return ast.parse((SCRIPTS / name).read_text())


def call_kwargs(call):
    """``dict(env=base_env, anneal=True, ...)`` as a dict, the env by
    name."""
    out = {}
    for kw in call.keywords:
        if isinstance(kw.value, ast.Name):
            out[kw.arg] = {"base_env": "base",
                           "shaped_env": "shaped"}[kw.value.id]
        else:
            out[kw.arg] = ast.literal_eval(kw.value)
    return out


def assigned(tree, target):
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == target
                    for t in n.targets)]


def test_ppo_sweep_tables_match_the_script():
    tree = script_ast("ppo_train_to_win.py")
    stages = assigned(tree, "stages")
    assert len(stages) == 2               # round 1, then round 2
    sc_expr = ast.Expression(assigned(tree, "sc")[0])
    for quick in (False, True):
        for scale in (1.0, 0.02, 0.37, 3.0):
            ns = argparse.Namespace(quick=quick, scale=scale)
            sc = eval(compile(sc_expr, "sc", "eval"), {"args": ns})
            for round2, node in ((False, stages[0]), (True, stages[1])):
                want = eval(compile(ast.Expression(node), "stages", "eval"),
                            {"int": int, "sc": sc})
                assert ship_rl.sweep_stages(scale, quick, round2) == want
    cands = assigned(tree, "candidates")
    assert len(cands) == 2
    for node, key in zip(cands, ("round2", "round1")):
        want = {ast.literal_eval(k): call_kwargs(v)
                for k, v in zip(node.keys, node.values)}
        assert ship_rl.SWEEP_CANDIDATES[key] == want


def test_ppo_ship_and_sac_ship_constants_match_the_scripts():
    tree = script_ast("ppo_ship_best.py")
    for name, got in (("STAGES", ship_rl.SHIP_STAGES),
                      ("HIDDEN", ship_rl.SHIP_HIDDEN),
                      ("BATCH", ship_rl.SHIP_BATCH),
                      ("EVAL_EPISODES", ship_rl.SHIP_EVAL_EPISODES)):
        assert ast.literal_eval(assigned(tree, name)[0]) == got
    probe = ast.literal_eval(assigned(tree, "CPU_PROBE")[0])
    assert f"train_on_device({ship_rl.CPU_PROBE_STEPS:_})" in probe
    assert "ent_coef=0.1" in probe


def script_options(name):
    """``--option: (type name, default, action)`` of a script's
    ``add_argument`` calls."""
    out = {}
    for n in ast.walk(script_ast(name)):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in n.keywords}
            out[ast.literal_eval(n.args[0])] = (
                kw["type"].id if "type" in kw else None,
                ast.literal_eval(kw["default"]) if "default" in kw else None,
                ast.literal_eval(kw["action"]) if "action" in kw else None)
    return out


@pytest.mark.parametrize("script, sub", [
    ("ppo_train_to_win.py", "ppo-sweep"), ("ppo_ship_best.py", "ppo-ship"),
    ("sac_ship_tpu.py", "sac-ship")])
def test_ship_rl_arguments_match_the_scripts(script, sub):
    parser = subcommands(ship_rl.build_parser())[sub]
    got = {}
    for a in parser._actions:
        if a.option_strings and a.dest not in ("help", "device"):
            action = ("store_true" if isinstance(a, argparse._StoreTrueAction)
                      else None)
            got[a.option_strings[0]] = (
                a.type.__name__ if a.type else None,
                None if action else a.default, action)
    want = {k: (t, None if act else d, act)
            for k, (t, d, act) in script_options(script).items()}
    assert got == want


NARROW = dict(z_dim=8, e_hidden_dim=16, f_hidden_dim=24, b_hidden_dim=16)


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A tiny ``train-chandelier`` on the CPU: 4 scenes in the three
    chunks, 2 steps a scene, narrow networks (the full width's guide is
    minutes of the distillation's renders on one CPU thread)."""
    d = tmp_path_factory.mktemp("ship")
    out = d / "teacher.npz"
    ship_models.main(["train-chandelier", "--scenes", "4", "--steps", "2",
                      "--z-dim", "8", "--e-hidden", "16", "--f-hidden", "24",
                      "--b-hidden", "16", "--out", str(out), "--workdir",
                      str(d / "work"), "--device", "cpu"])
    return out


def test_train_chandelier_teacher_loads_in_jax(teacher):
    from raytracer_tpu_torch.fb.config import FBConfig
    from raytracer_tpu_torch.utils.checkpoint import load_fb
    cfg = ship_models.config_from_ckpt(teacher)
    assert cfg == FBConfig(max_bounces=8, **NARROW)
    jcfg = JaxFBConfig(**dataclasses.asdict(cfg))
    with jax.enable_x64(False):
        params, meta, extra = jax_load_fb(str(teacher), jcfg)
    assert meta["f_hidden_dim"] == 24 and extra["noise_scale"] > 0
    nets = load_fb(teacher, cfg)[0]
    want = np.sort(np.concatenate([np.asarray(x, np.float32).ravel()
                                   for x in jax.tree_util.tree_leaves(
                                       params)]))
    got = np.sort(np.concatenate([p.detach().numpy().ravel()
                                  for n in nets.values()
                                  for p in n.parameters()]))
    np.testing.assert_array_equal(got, want)


def test_the_other_subcommands_run_on_cpu(teacher, tmp_path, monkeypatch,
                                          capsys):
    monkeypatch.chdir(tmp_path)
    student = tmp_path / "s.npz"
    ship_models.main(["distill", "--scene", "chandelier", "--teacher",
                      str(teacher), "--out", str(student), "--frames", "1",
                      "--epochs", "1", "--sharpen", "--device", "cpu"])
    assert student.exists()
    ship_models.main(["distill-ensemble", "--scene", "chandelier",
                      "--teachers", str(teacher), str(teacher), "--out",
                      str(tmp_path / "e.npz"), "--frames", "1", "--epochs",
                      "1", "--hidden", "8", "--device", "cpu"])
    ship_models.main(["distill-episodes", "--type", "cornell_box",
                      "--teacher", str(teacher), "--out",
                      str(tmp_path / "ep.npz"), "--scenes", "1",
                      "--walkers", "64", "--epochs", "1", "--hidden", "8",
                      "--sharpen", "--device", "cpu"])
    ship_models.main(["eval-multi", "--model", str(student), "--scenes",
                      "2", "--episodes", "16", "--device", "cpu"])
    report = json.loads(Path("build/ship/fb_multi_scene_held_out.json")
                        .read_text())
    assert report["num_scenes"] == 2
    stats = ship_models.main(["eval", "--scene", "chandelier", "--model",
                              str(student), "--size", "20x10", "--spp", "1",
                              "--device", "cpu"])
    assert stats["traditional"]["total_rays"] > 0
    held = ship_models.main(["heldout-chandelier", "--teacher", str(teacher),
                             "--tests", "16", "--render-size", "20x10",
                             "--render-spp", "1", "--device", "cpu"])
    assert held["teacher_one_step"]["num_tests"] == 16
    assert Path("build/ship/fb_chandelier_held_out.json").exists()
    out = capsys.readouterr().out
    assert "distilled" in out and "ensemble-distilled" in out


def test_ship_rl_runs_on_cpu(tmp_path, monkeypatch):
    """The three recipes end to end on a 16x12 env of one bounce (each
    ``train_on_device`` call runs at least 8 iterations)."""
    from raytracer_tpu_torch.env.raytracer_env import RayTracerEnv
    from raytracer_tpu_torch.env.scenes import training_scene_complete

    def small_env(device):
        scene, gl, pl = training_scene_complete(device=device)
        return RayTracerEnv(scene, image_width=16, image_height=12, fov=75,
                            max_bounces=1, global_lights=gl,
                            point_lights=pl, variant="rl")
    monkeypatch.setattr(ship_rl, "make_env", small_env)
    monkeypatch.chdir(tmp_path)
    small = dict(hidden=(8, 8), batch_envs=8)
    monkeypatch.setattr(ship_rl, "SWEEP_CANDIDATES", {
        r: {k: {**v, **small} for k, v in c.items()}
        for r, c in ship_rl.SWEEP_CANDIDATES.items()})
    sweep = ship_rl.main(["ppo-sweep", "--scale", "0.0001",
                          "--eval-episodes", "16", "--device", "cpu"])
    assert sweep["best"] in ship_rl.SWEEP_CANDIDATES["round1"]
    assert sweep["sweep"]["shaped_anneal"]["shaped"]
    assert [s["ent_coef"] for s in sweep["sweep"]["anneal"]["stages"]] == [
        0.1, 0.03, 0.01]
    assert (tmp_path / "build/ship/ppo_best.npz").exists()
    monkeypatch.setattr(ship_rl, "SHIP_STAGES", [(0.1, 8), (0.03, 8)])
    monkeypatch.setattr(ship_rl, "SHIP_HIDDEN", (8, 8))
    monkeypatch.setattr(ship_rl, "SHIP_BATCH", 8)
    monkeypatch.setattr(ship_rl, "SHIP_EVAL_EPISODES", 16)
    monkeypatch.setattr(ship_rl, "CPU_PROBE_STEPS", 8)
    rep = ship_rl.main(["ppo-ship", "--device", "cpu"])
    assert rep["cpu_probe_100k_steps"]["backend"] == "cpu"
    assert (tmp_path / "build/ship/ppo_raytracer_benchmark.json").exists()
    rep = ship_rl.main(["sac-ship", "--timesteps", "8", "--eval-episodes",
                        "16", "--cpu-probe-steps", "8", "--device", "cpu"])
    assert rep["card"]["backend"] == "cpu"
    assert (tmp_path / "build/ship/sac_raytracer_card.npz").exists()
