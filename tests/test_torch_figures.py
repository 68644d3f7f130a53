"""The port's matplotlib figures against the JAX package's, artist by
artist, and the flows that draw them without matplotlib.

Each figure function of both packages runs on the same data under Agg
with ``matplotlib.pyplot.savefig`` and ``close`` patched to capture the
figure: sizes, dpi, file names, titles, axis state, line data, bar
labels and heights, histogram counts, 3-D scatter offsets, sizes, face
and edge colours, and image arrays must be equal.  Then matplotlib is
hidden through ``sys.modules``: a figure function raises ``ImportError``,
and ``train-* --analyze``, ``run_custom_scene_experiment`` and
``render_comparison`` write their other outputs and print one line
saying the figure was not drawn."""
import sys

import jax
import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest

from raytracer_tpu.agents import analytics as jax_analytics
from raytracer_tpu.compare import experiment as jax_experiment
from raytracer_tpu.compare import rl_renderer as jax_rl_renderer
from raytracer_tpu.compare import workbench as jax_workbench
from raytracer_tpu.env import scenes as jax_scenes
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.agents import analytics
from raytracer_tpu_torch.compare import experiment, rl_renderer, workbench
from raytracer_tpu_torch.env import scenes
from raytracer_tpu_torch.scene import library

from test_torch_scene import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

matplotlib.use("Agg")


def describe_axes(ax):
    d = {"title": ax.get_title(), "axis_on": ax.axison,
         "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
         "position": np.round(ax.get_position().bounds, 6)}
    if hasattr(ax, "get_zlabel"):
        d["zlabel"] = ax.get_zlabel()
    d["lines"] = []
    for ln in ax.get_lines():
        data = (ln.get_data_3d() if hasattr(ln, "get_data_3d")
                else ln.get_data())
        d["lines"].append({"data": [np.asarray(x, float) for x in data],
                           "lw": ln.get_linewidth(),
                           "alpha": ln.get_alpha()})
    d["patches"] = [(np.asarray(p.get_xy(), float) if hasattr(p, "get_xy")
                     else None, p.get_height() if hasattr(p, "get_height")
                     else None, p.get_width() if hasattr(p, "get_width")
                     else None) for p in ax.patches]
    d["xticklabels"] = [t.get_text() for t in ax.get_xticklabels()]
    d["collections"] = []
    for c in ax.collections:
        offs = (np.asarray(c._offsets3d, float) if hasattr(c, "_offsets3d")
                else np.asarray(c.get_offsets(), float))
        d["collections"].append({
            "offsets": offs, "sizes": np.asarray(c.get_sizes(), float),
            "face": np.asarray(c.get_facecolors(), float),
            "edge": np.asarray(c.get_edgecolors(), float)})
    d["images"] = [np.asarray(im.get_array()) for im in ax.get_images()]
    return d


def describe(fig, kw):
    return {"size": tuple(fig.get_size_inches()),
            "dpi": kw.get("dpi"), "bbox": kw.get("bbox_inches"),
            "axes": [describe_axes(ax) for ax in fig.axes]}


@pytest.fixture
def capture(monkeypatch):
    """``savefig``/``close`` patched: each saved figure's description and
    the name of its file."""
    seen = []

    def savefig(path, **kw):
        seen.append((str(path).rsplit("/", 1)[-1], describe(plt.gcf(), kw)))

    monkeypatch.setattr(plt, "savefig", savefig)
    monkeypatch.setattr(plt, "close", lambda fig=None: None)
    yield seen
    plt.close("all")


def assert_equal_tree(a, b, where="figure"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_equal_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def both(capture, draw_jax, draw_port):
    with jax.enable_x64(False):
        draw_jax()
    draw_port()
    (jname, want), (pname, got) = capture[-2:]
    assert len(capture) == 2 and jname == pname
    assert_equal_tree(got, want)
    return want


BEHAVIOR = {"hit_frequency_by_id": {2: 40, -1: 100, 99: 12},
            "success_rate_by_bounce": {0: 0.1, 1: 0.5, 3: 0.25},
            "termination_reasons": {"ray_escaped": 80, "max_bounces": 12,
                                    "terminal": 8}}


@pytest.mark.parametrize("n", [5, 40])
def test_advanced_analysis_png(capture, n):
    rh = np.random.default_rng(n).normal(size=n)
    want = both(capture,
                lambda: jax_analytics.advanced_analysis_png(
                    BEHAVIOR, rh, "a.png"),
                lambda: analytics.advanced_analysis_png(
                    BEHAVIOR, rh, "a.png"))
    assert want["size"] == (16, 9) and want["dpi"] == 100
    assert len(want["axes"][1]["lines"]) == (n > 10)


def test_plot_3d_paths(capture):
    rng = np.random.default_rng(0)
    paths = [rng.normal(size=(k, 3)).astype(np.float32) for k in (2, 4, 3)]
    with jax.enable_x64(False):
        js, _, _ = jax_scenes.training_scene_v1()
    ts, _, _ = scenes.training_scene_v1(device="cpu")
    want = both(capture, lambda: jax_analytics.plot_3d_paths(
        paths, js, "p.png"), lambda: analytics.plot_3d_paths(
        paths, ts, "p.png"))
    assert len(want["axes"][0]["lines"]) == 3
    assert want["axes"][0]["collections"][0]["offsets"].shape == (3, 5)


@pytest.mark.parametrize("name", ["chandelier", "custom"])
def test_plot_scene_3d(capture, name):
    with jax.enable_x64(False):
        js = getattr(jax_library, f"{name}_scene")()[0]
    ts = getattr(library, f"{name}_scene")(device="cpu")[0]
    want = both(capture, lambda: jax_workbench.plot_scene_3d(js, "s.png"),
                lambda: workbench.plot_scene_3d(ts, "s.png"))
    edge = want["axes"][0]["collections"][0]["edge"]
    assert len(edge) > 1


def test_performance_plots(capture):
    rng = np.random.default_rng(1)
    history = {"rewards": rng.normal(size=50), "empty": [],
               "reward_hist": rng.normal(size=200),
               "bounces": rng.integers(0, 5, 12), "hit_rate": [0.1, 0.2],
               "loss": rng.random(30), "extra": [1.0], "seventh": [2.0]}
    want = both(capture,
                lambda: jax_workbench.performance_plots(history, "h.png"),
                lambda: workbench.performance_plots(history, "h.png"))
    assert [a["title"] for a in want["axes"]] == [
        "rewards", "reward_hist", "bounces", "hit_rate", "loss", "extra"]


@pytest.mark.parametrize("with_trials", [True, False])
def test_custom_scene_visualization(capture, tmp_path, with_trials):
    rng = np.random.default_rng(2)
    images = {n: rng.random((6, 7, 3)) * 1.2 for n in
              ("true_original", "traditional", "fb", "rl")}
    trials = {m: {"avg_reward": float(i) / 3, "avg_light_hits": i / 7,
                  "trials": 2} for i, m in enumerate(("traditional", "fb",
                                                      "rl"))}
    je = jax_experiment.CustomSceneExperiment(output_dir=str(tmp_path / "j"))
    pe = experiment.CustomSceneExperiment(output_dir=str(tmp_path / "p"),
                                          device="cpu")
    if with_trials:
        je.results["trials"] = pe.results["trials"] = trials
    want = both(capture, lambda: je.create_custom_scene_visualization(images),
                lambda: pe.create_custom_scene_visualization(images))
    assert len(want["axes"]) == (6 if with_trials else 4)
    assert capture[-1][0] == "custom_scene_analysis.png"


@pytest.mark.parametrize("use_rl", [True, False])
def test_render_comparison_figure(capture, monkeypatch, tmp_path, use_rl):
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(0, 255, (6, 8, 3)) for _ in range(2)]
    out = str(tmp_path / "cmp.png")
    objs = []
    for mod, kw in ((jax_rl_renderer, {}), (rl_renderer, {"device": "cpu"})):
        r = mod.RayTracerRL(model_path=None, **kw)
        r.use_rl = use_rl
        monkeypatch.setattr(r, "render_single_view",
                            lambda w, h, use_rl=True: imgs[0 if use_rl
                                                           else 1])
        objs.append(r)
    want = both(capture, lambda: objs[0].render_comparison(8, 6, out),
                lambda: objs[1].render_comparison(8, 6, out))
    assert want["dpi"] == 120 and want["axes"][0]["title"] == (
        "RL-guided" if use_rl else "RL (fallback)")


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith(("matplotlib.",
                                                    "mpl_toolkits")):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_figure_functions_raise_without_matplotlib(no_matplotlib, tmp_path):
    ts, _, _, _ = library.custom_scene(device="cpu")
    pe = experiment.CustomSceneExperiment(output_dir=str(tmp_path),
                                          device="cpu")
    calls = [lambda: analytics.advanced_analysis_png(BEHAVIOR, [1.0], "a"),
             lambda: analytics.plot_3d_paths([], ts, "p"),
             lambda: workbench.plot_scene_3d(ts, "s"),
             lambda: workbench.performance_plots({}, "h"),
             lambda: pe.create_custom_scene_visualization(),
             lambda: rl_renderer.RayTracerRL(
                 None, device="cpu").comparison_figure(None, None, "c")]
    for call in calls:
        with pytest.raises(ImportError):
            call()


def test_flows_complete_without_matplotlib(no_matplotlib, tmp_path,
                                           monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cli.main(["train-ppo", "--timesteps", "100", "--out", "p.npz",
              "--analyze", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ppo_analysis.png not drawn: matplotlib is not installed" in out
    assert (tmp_path / "ppo_analysis.csv").exists()
    assert not (tmp_path / "ppo_analysis.png").exists()

    exp = experiment.CustomSceneExperiment(output_dir=str(tmp_path / "e"),
                                           mode="fast_mode", device="cpu")
    exp.config["trials"] = 1
    res = exp.run_custom_scene_experiment()
    out = capsys.readouterr().out
    assert res.exists() and (exp.output_dir / "unified_comparison.png"
                             ).exists()
    assert not (exp.output_dir / "custom_scene_analysis.png").exists()
    assert out.count("not drawn: matplotlib is not installed") == 1
    assert "custom_scene_analysis.png not drawn" in out

    r = rl_renderer.RayTracerRL(model_path=None, device="cpu")
    capsys.readouterr()
    rl_img, trad_img = r.render_comparison(12, 8, str(tmp_path / "c.png"))
    out = capsys.readouterr().out
    assert "c.png not drawn: matplotlib is not installed" in out
    from PIL import Image
    side = np.asarray(Image.open(tmp_path / "c.png"))
    assert side.shape == (8, 24, 3)
    np.testing.assert_array_equal(side[:, :12], rl_img.astype(np.uint8))
