"""The port's FB trainers (raytracer_tpu_torch/fb/trainer.py) and event
writer (utils/tb.py), at a tiny config on the CPU.

Training draws its own walks (a ``torch.Generator``), so bit parity with
JAX is not possible here: the trainers are held as JAX holds its own
(tests/test_fb_trainer.py): the report's schema, its files, resume, the
render probe's determinism and selection, and seeded statistics of a run.
The walk, the updates and the checkpoints they are built from are held
against JAX in tests/test_torch_fb_walk.py and test_torch_fb_learner.py.

* The final report's nested key sets equal those JAX's ``_final_report``
  builds (tests/test_fb_trainer.py:98-123), with a probe history.
* ``resume_from`` restores parameters, noise scale and update count, and
  ``scene_offset`` continues the variation sequence.
* ``render_probe`` is deterministic in its seed; ``probe_scene`` picks a
  variation with signal; ``probe_every`` records a history and keeps
  ``best_render_probe.npz``.
* The event file equals JAX's writer's byte for byte under a fixed clock.
"""
import json
import os

import numpy as np
import pytest
import torch

from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.fb.trainer import MultiSceneFBTrainer as JaxTrainer
from raytracer_tpu.utils import tb as jax_tb
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.trainer import (ChandelierOnlyTrainer,
                                            MultiSceneFBTrainer,
                                            RayTracedComplexTrainer)
from raytracer_tpu_torch.scene import templates
from raytracer_tpu_torch.utils import tb

from test_torch_fb_learner import (  # noqa: F401  (autouse fixture)
    hidden_loader_stub, without_leaked_loader_stub)

TINY = dict(z_dim=16, e_hidden_dim=64, f_hidden_dim=64, b_hidden_dim=32,
            batch_size=32, update_freq=64, buffer_capacity=10_000,
            max_bounces=4)


def _trainer(path, **kw):
    return MultiSceneFBTrainer(num_training_scenes=8, config=FBConfig(**TINY),
                               output_dir=path, device="cpu", **kw)


def _keys(obj, free=("scene_specific_memory",)):
    """Nested key sets; a list as its first element's; the keys under
    ``free`` are data (scene types), not schema."""
    if isinstance(obj, dict):
        return {k: (None if k in free else _keys(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return None


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = tmp_path_factory.mktemp("fb") / "run"
    with hidden_loader_stub():
        tr = _trainer(path)
        tr.tensorboard_log = str(path / "tb")
        report = tr.run_training(num_scenes=8, scenes_per_batch=4,
                                 training_steps_per_scene=64)
    return tr, report, path


def test_report_schema_equals_jax(trained, tmp_path):
    tr, report, path = trained
    assert set(report) == {"training_summary", "performance_statistics",
                           "scene_type_performance", "all_performances"}
    jt = JaxTrainer(num_training_scenes=2, config=JaxConfig(**TINY),
                    output_dir=tmp_path / "jax")
    jt.all_performances = report["all_performances"]
    jt.agent.losses = [1.0]
    want = jt._final_report(1.0)
    assert _keys(report) == _keys(want)
    assert report["training_summary"]["device"] == "cpu"
    for f in ("final_training_report.json", "fb_multi_scene_final.npz",
              "checkpoint_batch_1.npz", "checkpoint_batch_2.npz",
              "performance_batch_2.json"):
        assert (path / f).exists(), f
    saved = json.loads((path / "final_training_report.json").read_text())
    assert _keys(saved) == _keys(report)


def test_training_statistics(trained):
    """JAX's end-to-end test's statistics (tests/test_fb_trainer.py:97-125):
    the agent trained and its stats are measured."""
    tr, report, path = trained
    ps = report["performance_statistics"]
    assert ps["total_scenes_trained"] == 8 and ps["scene_types_trained"] == 8
    assert len(report["all_performances"]) == 8
    assert tr.agent.buffer.size > 0 and tr.agent.updates > 0
    assert np.isfinite(tr.agent.losses).all() and ps["avg_loss"] is not None
    ast = report["training_summary"]["agent_stats"]
    assert ast["adaptability"]["num_scenes_encountered"] == 8
    assert ast["adaptability"]["scene_specific_memory"]
    assert ast["performance"]["total_rays"] > 0
    assert len(tr.agent.head_var_history) == tr.agent.updates
    # The seeded run reaches lights (small-biased starts): hits recorded,
    # light memory filled.
    assert ast["performance"]["light_hits"] > 0
    assert ast["generalization"]["light_memory_size"] > 0
    held = tr.test_on_complex(num_tests=64)
    assert 0.0 <= held["agent_hit_rate"] <= 1.0
    assert 0.0 <= held["random_hit_rate_core"] <= 1.0
    assert (path / "held_out_complex_test.json").exists()
    runs = os.listdir(path / "tb")
    assert runs == ["FB_1"]


def test_resume_from_checkpoint(trained, tmp_path):
    tr, _, path = trained
    tr.agent.noise_scale = 0.0321
    ckpt = tmp_path / "ckpt.npz"
    tr.agent.save(ckpt)
    tr2 = _trainer(tmp_path / "b", resume_from=str(ckpt))
    assert tr2.agent.noise_scale == pytest.approx(0.0321)
    assert tr2.agent.updates == tr.agent.updates
    for a, b in zip(tr.agent.encoder.parameters(),
                    tr2.agent.encoder.parameters()):
        assert torch.equal(a, b)
    assert tr2.make_scene(8)[1] != tr.make_scene(0)[1]
    report = tr2.run_training(num_scenes=2, scenes_per_batch=2,
                              training_steps_per_scene=16, scene_offset=8)
    assert report["performance_statistics"]["total_scenes_trained"] == 2
    assert report["all_performances"][0]["scene"] == "complex_scene_v8"


def test_render_probe_deterministic_and_in_training(tmp_path):
    tr = _trainer(tmp_path / "p")
    scene, _ = templates.generate_scene("cornell_box", 99, pad_to=64,
                                        device="cpu")
    a = tr.render_probe(scene, width=32, height=16, spp=1, seed=3)
    b = tr.render_probe(scene, width=32, height=16, spp=1, seed=3)
    assert a == b
    assert a["metric"] in ("small_light_hits", "light_hits")
    assert a["traditional_light_hits"] >= a["traditional_small_light_hits"]
    assert a["improvement"] >= 0.0
    ps, pname, sig = tr.probe_scene()
    assert sig >= tr.PROBE_MIN_SIGNAL, (pname, sig)
    tr.probe_every = 1
    report = tr.run_training(num_scenes=2, scenes_per_batch=2,
                             training_steps_per_scene=8)
    hist = report["training_summary"]["render_probe_history"]
    assert [h["after_scene"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["improvement"]) and h["scene"] == pname
               for h in hist)
    assert all(h[f"traditional_{h['metric']}"] >= tr.PROBE_MIN_SIGNAL
               for h in hist)
    assert (tmp_path / "p" / "best_render_probe.npz").exists()


def test_chandelier_and_complex_trainers(tmp_path):
    tr = ChandelierOnlyTrainer(num_training_scenes=2, device="cpu",
                               output_dir=tmp_path / "c")
    s, name, stype = tr.make_scene(0)
    assert stype == "chandelier" and name == "chandelier_scene_v0"
    assert s.num_spheres == 64 and tr.START_BIAS == "mixed"
    assert (tr.config.f_hidden_dim, tr.config.b_hidden_dim,
            tr.config.max_bounces) == (512, 256, 8)
    tr2 = RayTracedComplexTrainer(num_training_scenes=2, device="cpu",
                                  output_dir=tmp_path / "x",
                                  config=FBConfig(**TINY))
    assert tr2.make_scene(1)[2] == "complex"
    small = ChandelierOnlyTrainer(num_training_scenes=1, device="cpu",
                                  output_dir=tmp_path / "s",
                                  config=FBConfig(**TINY), guide_prob=0.5)
    for i in range(6):                     # until a small light is hit
        small.train_on_scene(*small.make_scene(i)[:2], episodes=256)
        if small.agent.light_memory:
            break
    assert small.agent.light_memory        # so the next walk is guided
    guides, live = [], small.agent.guide
    small.agent.guide = lambda: guides.append(live()) or guides[-1]
    small.train_on_scene(*small.make_scene(7)[:2], episodes=64)
    assert len(guides) == 1
    res = small.test_on_chandelier(num_tests=32)
    assert res["num_tests"] == 32
    assert (tmp_path / "s" / "held_out_chandelier_test.json").exists()


def test_event_file_equals_jax_writer(tmp_path, monkeypatch):
    monkeypatch.setattr(tb.time, "time", lambda: 1234567890.5)
    monkeypatch.setattr(tb.socket, "gethostname", lambda: "host")
    paths = []
    for mod, sub in ((tb, "port"), (jax_tb, "jax")):
        run = mod.next_run_dir(str(tmp_path / sub), "FB")
        assert run.endswith("FB_1")
        with mod.SummaryWriter(run) as w:
            for i in range(3):
                w.add_scalar("train/scene_hit_rate", 12.5 * i, i)
        paths.append(w.path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and len(a) > 0
