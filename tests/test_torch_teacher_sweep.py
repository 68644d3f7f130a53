"""raytracer_tpu_torch/tools/teacher_sweep.py: the guided chunk's training
hit rate read from a run's report, the seed list, the two-set comparison
against scipy's tests, and ``train`` on the CPU at a narrow width."""
import json
from pathlib import Path

import numpy as np
import pytest
from scipy import stats

from raytracer_tpu_torch.tools import teacher_sweep

REPORT = (Path(__file__).resolve().parents[1] / "models"
          / "fb_chandelier_training_report.json")


def test_seeds_and_rates(tmp_path):
    assert teacher_sweep.parse_seeds("12-15,20") == [12, 13, 14, 15, 20]
    assert teacher_sweep.parse_seeds("7") == [7]
    rates = [float(i) for i in range(320)]
    assert teacher_sweep.guided_rate(rates) == np.mean(rates[160:])
    assert teacher_sweep.quarter_means(rates) == [
        np.mean(rates[i:i + 80]) for i in range(0, 320, 80)]
    report = {"all_performances": [{"hit_rate": r} for r in rates]}
    summary = {"rate": 1.25}
    (tmp_path / "r.json").write_text(json.dumps(report))
    (tmp_path / "s.json").write_text(json.dumps(summary))
    assert teacher_sweep.read_rate(tmp_path / "r.json") == np.mean(
        rates[160:])
    assert teacher_sweep.read_rate(tmp_path / "s.json") == 1.25


def test_shipped_teacher_rate():
    """The shipped teacher's guided chunk, the number the seed comparison
    carries for it: the mean of its report's last 160 scenes."""
    d = json.loads(REPORT.read_text())
    rates = [p["hit_rate"] for p in d["all_performances"]]
    assert len(rates) == 320
    assert teacher_sweep.read_rate(REPORT) == pytest.approx(
        np.mean(rates[160:]), abs=0)
    assert round(teacher_sweep.read_rate(REPORT), 2) == 3.93


def test_compare_is_scipys():
    rng = np.random.default_rng(3)
    a, b = rng.normal(3.3, 0.3, 40), rng.normal(3.4, 0.3, 18)
    got = teacher_sweep.compare(a, b)
    assert got["a"] == {"n": 40, "mean": float(a.mean()),
                        "sd": float(a.std(ddof=1))}
    assert got["b"]["n"] == 18
    assert got["welch_p"] == stats.ttest_ind(a, b, equal_var=False).pvalue
    assert got["mann_whitney_p"] == stats.mannwhitneyu(
        a, b, alternative="two-sided").pvalue


def test_train_writes_summaries(tmp_path, capsys):
    """``train`` runs ``ship_models train-chandelier`` a seed, two at once,
    and writes each seed's summary from the run's report."""
    out = tmp_path / "sweep"
    teacher_sweep.main(["train", "--seeds", "1-2", "--parallel", "2",
                        "--scenes", "4", "--out", str(out), "--device",
                        "cpu", "--", "--steps", "8", "--z-dim", "8",
                        "--e-hidden", "16", "--f-hidden", "16",
                        "--b-hidden", "8"])
    for s in (1, 2):
        d = json.loads((out / f"s{s}.json").read_text())
        report = json.loads(
            (out / f"w{s}" / "final_training_report.json").read_text())
        rates = [p["hit_rate"] for p in report["all_performances"]]
        assert d["seed"] == s and d["hit_rates"] == rates
        assert d["rate"] == np.mean(rates[2:]) and d["device"] == "cpu"
        assert (out / f"s{s}.npz").exists()
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["seeds"] == [1, 2]
