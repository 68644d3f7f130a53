"""The port's CLI (raytracer_tpu_torch/cli.py, console script
``raytracer-tpu-torch``): each command parses as the JAX CLI's does (same
arguments, same defaults, plus ``--device``), and ``render --device cpu``
writes the same PNG bytes as the JAX CLI's ``cmd_render`` pipeline run op
by op with 64-bit mode off (both write through ``native/imageio.cpp``).
Jitted, XLA turns the image's ``/ 255`` into a multiply by the
reciprocal, and the CLI's truncation to 8 bits can move a pixel by one
step."""
import argparse
import tomllib
from pathlib import Path

import jax
import pytest

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
]


def jax_args(monkeypatch, argv):
    """The namespace the JAX CLI's ``main`` builds for ``argv`` (its
    command functions and compilation-cache setup stubbed out)."""
    seen = {}
    monkeypatch.setattr(jax_cli, "_enable_compilation_cache", lambda: None)
    for name in ("cmd_render", "cmd_train_fb", "cmd_compare",
                 "cmd_experiment"):
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


def test_device_option_and_unported_commands():
    args = cli.build_parser().parse_args(["experiment", "--device", "cpu"])
    assert args.device == "cpu"
    for name in ("animate", "train-ppo", "train-sac", "train-q", "demo",
                 "interactive", "rl-pipeline"):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args([name])


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
