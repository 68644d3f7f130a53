"""The port's CLI (raytracer_tpu_torch/cli.py, console script
``raytracer-tpu-torch``): each command parses as the JAX CLI's does (same
arguments, same defaults, plus ``--device``), the RL commands run with
``--device cpu``, and ``render --device cpu``
writes the same PNG bytes as the JAX CLI's ``cmd_render`` pipeline run op
by op with 64-bit mode off (both write through ``native/imageio.cpp``).
Jitted, XLA turns the image's ``/ 255`` into a multiply by the
reciprocal, and the CLI's truncation to 8 bits can move a pixel by one
step."""
import argparse
import contextlib
import json
import tomllib
from pathlib import Path

import jax
import pytest
import torch

import raytracer_tpu.cli as jax_cli
from raytracer_tpu_torch import cli

from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


ROOT = Path(__file__).resolve().parents[1]

ARGVS = [
    ["render"],
    ["render", "--scene", "marbles4", "--out", "x.png", "--multiple", "2"],
    ["render", "--scene", "chandelier", "--width", "16", "--height", "12"],
    ["train-fb"],
    ["train-fb-chandelier", "--quick"],
    ["train-fb-complex", "--scenes", "7", "--probe-every", "3"],
    ["compare-chandelier"],
    ["compare-chandelier", "--model", "m.npz", "--width", "100", "--height",
     "50", "--spp", "4", "--bounces", "6", "--fb-spp", "2", "--spp-chunk",
     "2", "--out", "o", "--timing-iters", "3"],
    ["compare-complex"],
    ["experiment"],
    ["experiment", "--mode", "fast_mode"],
    ["train-ppo"],
    ["train-ppo", "--timesteps", "9", "--lr", "0.1", "--seed", "2", "--out",
     "p.npz", "--analyze", "--tensorboard-log", "tb"],
    ["train-sac"],
    ["train-sac", "--timesteps", "9", "--out", "s.pkl"],
    ["train-q"],
    ["train-q", "--episodes", "7", "--seed", "1"],
    ["demo"],
    ["demo", "--seed", "3"],
    ["rl-pipeline"],
    ["rl-pipeline", "--algo", "ppo", "--timesteps", "9", "--seed", "1",
     "--out", "r.npz", "--cpu", "--tensorboard-log", "tb"],
    ["animate"],
    ["animate", "--scene", "planets2", "--frames", "24", "--width", "400",
     "--height", "300"],
    ["animate", "--scene", "chandelier", "--tracer", "path", "--guide",
     "registry", "--frames", "12", "--width", "200", "--height", "100",
     "--spp", "4", "--bounces", "8"],
    ["animate", "--scene", "cornell_box:7", "--tracer", "path", "--guide",
     "s.npz", "--seed", "3", "--radius", "2.5", "--y", "1", "--sweep",
     "3.14", "--target", "0", "1", "2", "--fps", "5", "--fov", "45",
     "--out-dir", "o"],
]
RL_COMMANDS = {
    "train-ppo": ["--timesteps", "100", "--out", "ppo.npz", "--analyze"],
    "train-sac": ["--timesteps", "100", "--out", "sac.pkl"],
    "train-q": ["--episodes", "64"],
    "demo": ["--seed", "1"],
    "rl-pipeline --algo sac": ["--timesteps", "100", "--out", "sac.npz"],
    "rl-pipeline --algo ppo": ["--timesteps", "100", "--out", "ppo.npz"],
}


def jax_args(monkeypatch, argv):
    """The namespace the JAX CLI's ``main`` builds for ``argv`` (its
    command functions and compilation-cache setup stubbed out)."""
    seen = {}
    monkeypatch.setattr(jax_cli, "_enable_compilation_cache", lambda: None)
    for name in ("cmd_render", "cmd_animate", "cmd_train_fb", "cmd_compare",
                 "cmd_experiment", "cmd_train_ppo", "cmd_train_sac",
                 "cmd_train_q", "cmd_demo", "cmd_rl_pipeline"):
        monkeypatch.setattr(jax_cli, name,
                            lambda a, *_, **__: seen.setdefault("args", a))
    jax_cli.main(argv)
    return vars(seen["args"])


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_commands_parse_as_jax(monkeypatch, argv):
    got = vars(cli.build_parser().parse_args(argv))
    want = jax_args(monkeypatch, argv)
    assert got.pop("device") == "cuda"
    for ns in (got, want):
        ns.pop("fn")
    assert got == want


def test_device_option_and_unported_commands(monkeypatch):
    """``--device`` on a command; ``interactive`` (ported since) parses as
    the JAX CLI's, plus ``--device``; an unknown command is refused."""
    args = cli.build_parser().parse_args(["experiment", "--device", "cpu"])
    assert args.device == "cpu"
    for argv in (["interactive"], ["interactive", "--seed", "4"]):
        got = vars(cli.build_parser().parse_args(argv))
        assert got.pop("fn") is cli.cmd_interactive
        assert got.pop("device") == "cuda"
        seen = {}
        monkeypatch.setattr(jax_cli, "cmd_interactive",
                            lambda a: seen.setdefault("args", a))
        monkeypatch.setattr(jax_cli, "_enable_compilation_cache",
                            lambda: None)
        jax_cli.main(argv)
        want = vars(seen["args"])
        want.pop("fn")
        assert got == want
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["no-such-command"])


@pytest.mark.parametrize("command", sorted(RL_COMMANDS))
def test_rl_commands_run_on_cpu(tmp_path, monkeypatch, capsys, command):
    """Each RL command end to end with ``--device cpu`` at a tiny size;
    without ``--device`` it asks for the card and, with none, raises."""
    monkeypatch.chdir(tmp_path)
    argv = command.split() + RL_COMMANDS[command]
    cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    if command.startswith("rl-pipeline"):
        stem = argv[argv.index("--out") + 1].rsplit(".", 1)[0]
        bench = json.loads((tmp_path / f"{stem}_benchmark.json").read_text())
        assert set(bench["rl"]) == set(bench["random"])
        assert (tmp_path / argv[argv.index("--out") + 1]).exists()
    elif command.startswith("train-") and command != "train-q":
        assert (tmp_path / argv[argv.index("--out") + 1]).exists()
    if "--analyze" in argv:
        assert (tmp_path / "ppo_analysis.csv").exists()
        from raytracer_tpu_torch.utils.figures import have_matplotlib
        if have_matplotlib():
            assert (tmp_path / "ppo_analysis.png").exists()
        else:
            assert "ppo_analysis.png not drawn" in out
    if command == "demo":
        assert "total reward" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_console_script_is_declared():
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())
    scripts = project["project"]["scripts"]
    assert scripts["raytracer-tpu-torch"] == "raytracer_tpu_torch.cli:main"
    assert scripts["raytracer-tpu"] == "raytracer_tpu.cli:main"


@pytest.mark.parametrize("scene, size", [("chandelier", ("40", "30")),
                                         ("marbles4", None)])
def test_render_writes_jax_png_bytes(tmp_path, scene, size):
    argv = ["render", "--scene", scene]
    if size:
        argv += ["--width", size[0], "--height", size[1]]
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    cli.main(argv + ["--out", str(ours), "--device", "cpu"])
    ns = argparse.Namespace(scene=scene, out=str(theirs), multiple=None,
                            width=int(size[0]) if size else 800,
                            height=int(size[1]) if size else 600)
    with jax.enable_x64(False), jax.disable_jit():
        jax_cli.cmd_render(ns)
    assert ours.read_bytes() == theirs.read_bytes()


def test_imageio_matches_jax(tmp_path, monkeypatch):
    """``utils/io.py``: the native library built into ``build/``;
    ``quantise_unit`` equal to JAX's; PNG, PPM and APNG files byte-equal to
    JAX's writers'; without the library, numpy's quantisation and PIL's
    writer."""
    import numpy as np
    from PIL import Image
    from raytracer_tpu.utils import io as jax_io
    from raytracer_tpu_torch.utils import io

    lib = io._load()
    assert lib is not None
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.2, 1.2, (20, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(io.quantise_unit(img),
                                  jax_io.quantise_unit(img))
    u8 = io.quantise_unit(img)
    frames = rng.integers(0, 256, (3, 8, 10, 3)).astype(np.uint8)
    for name in ("a.png", "a.ppm"):
        io.save_image(tmp_path / f"port_{name}", u8)
        jax_io.save_image(tmp_path / f"jax_{name}", u8)
        assert ((tmp_path / f"port_{name}").read_bytes()
                == (tmp_path / f"jax_{name}").read_bytes())
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / f"port_{name}")), u8)
    io.save_apng(tmp_path / "port.apng", frames, fps=5)
    jax_io.save_apng(tmp_path / "jax.apng", frames, fps=5)
    assert ((tmp_path / "port.apng").read_bytes()
            == (tmp_path / "jax.apng").read_bytes())
    with pytest.raises(ValueError, match="F,H,W,3"):
        io.save_apng(tmp_path / "bad.apng", frames[0])

    monkeypatch.setattr(io, "_lib", None)
    monkeypatch.setattr(io, "_tried", True)
    np.testing.assert_array_equal(io.quantise_unit(img), u8)
    io.save_image(tmp_path / "pil.png", u8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "pil.png")), u8)


def test_run_logger_and_csv_match_jax(tmp_path):
    from raytracer_tpu.utils import metrics as jax_metrics
    from raytracer_tpu_torch.utils import metrics

    with metrics.RunLogger(tmp_path / "log" / "run.jsonl") as log:
        log.log(0, loss=1.5)
        log.log(1, loss=0.5, hits=3)
    lines = (tmp_path / "log" / "run.jsonl").read_text().splitlines()
    import json
    recs = [json.loads(ln) for ln in lines]
    assert [r["step"] for r in recs] == [0, 1] and recs[1]["hits"] == 3
    rows = [{"episode": 0, "reward": 1.0}, {"episode": 1, "reward": 2.5}]
    metrics.write_csv(tmp_path / "port.csv", rows)
    jax_metrics.write_csv(tmp_path / "jax.csv", rows)
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
    metrics.write_csv(tmp_path / "empty.csv", [])
    assert (tmp_path / "empty.csv").read_text() == ""


ANIMATE = {
    "whitted": ["--scene", "custom", "--frames", "2", "--width", "16",
                "--height", "12"],
    "path": ["--scene", "chandelier", "--tracer", "path", "--frames", "2",
             "--width", "16", "--height", "8", "--spp", "1", "--bounces",
             "2"],
}


@pytest.mark.parametrize("tracer", sorted(ANIMATE))
def test_animate_writes_jax_files(tmp_path, capsys, tracer):
    """``animate --device cpu`` and the JAX CLI's ``cmd_animate`` on the
    same arguments: the same files and ``animation_stats.json`` keys (the
    shared ones equal, but the times); Whitted frames byte-equal to JAX's
    run op by op with 64-bit mode off (path frames draw other noise)."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    cli.main(["animate", *ANIMATE[tracer], "--out-dir", str(ours),
              "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ns = vars(cli.build_parser().parse_args(
        ["animate", *ANIMATE[tracer], "--out-dir", str(theirs)]))
    for k in ("device", "fn", "cmd"):
        ns.pop(k)
    with jax.enable_x64(False), contextlib.ExitStack() as stack:
        if tracer == "whitted":          # op by op: the PNG bytes
            stack.enter_context(jax.disable_jit())
        jax_cli.cmd_animate(argparse.Namespace(**ns))
    files = sorted(p.name for p in ours.iterdir())
    assert files == sorted(p.name for p in theirs.iterdir())
    assert {"frame_000.png", "frame_001.png", "contact_sheet.png",
            "animation.png", "animation_stats.json"} == set(files)
    got = json.loads((ours / "animation_stats.json").read_text())
    want = json.loads((theirs / "animation_stats.json").read_text())
    assert set(got) == set(want)
    for k in ("frames", "width", "height", "bounces", "target", "radius",
              "y", "tracer", "spp", "guided"):
        assert got.get(k) == want.get(k), k
    if tracer == "whitted":
        for name in ("frame_000.png", "frame_001.png", "contact_sheet.png",
                     "animation.png"):
            assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    else:
        assert got["total_rays"] > 0 and not got["guided"]
    assert printed == got


def test_animate_template_scene(tmp_path):
    """A template scene animates through the path tracer with the
    registry's student (the cornell copy in ``fb/students/``); Whitted on a
    template, and an unknown scene, end the command."""
    out = tmp_path / "cornell"
    cli.main(["animate", "--scene", "cornell_box:1007", "--tracer", "path",
              "--guide", "registry", "--frames", "2", "--width", "16",
              "--height", "8", "--spp", "1", "--bounces", "2", "--out-dir",
              str(out), "--device", "cpu"])
    stats = json.loads((out / "animation_stats.json").read_text())
    assert stats["guided"] and stats["total_rays"] > 0
    for argv in (["--scene", "cornell_box:1007"],
                 ["--scene", "nope", "--tracer", "path"]):
        with pytest.raises(SystemExit):
            cli.main(["animate", *argv, "--out-dir", str(out), "--device",
                      "cpu"])


def test_profiling_utilities(tmp_path, capsys):
    """``utils/profiling.py``: ``Timer`` reports as JAX's does, ``progress``
    yields every item, and ``device_trace`` writes a Chrome trace of the
    block (here the CPU's activity)."""
    from raytracer_tpu.utils import profiling as jax_profiling
    from raytracer_tpu_torch.utils import profiling

    with profiling.Timer("frame", rays=2_000_000) as t:
        torch.ones(1000).sum()
    with jax_profiling.Timer("frame", rays=2_000_000) as jt:
        pass
    jt.elapsed = t.elapsed
    assert t.elapsed > 0 and t.report() == jt.report()
    assert t.rays_per_second == pytest.approx(2e6 / t.elapsed)
    assert list(profiling.progress(range(5), desc="x")) == list(range(5))
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
