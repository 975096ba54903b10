"""The port's survival statistics and ``evaluate_scores`` against the JAX
package, on the CPU.

Inputs are made from a seed with numpy: censored cohorts with tied times
(a 3-month grid) and tied scores. The host statistics are the same float64
numpy in both stacks and are held at ``rtol=1e-12``; the bootstrap's
pairs are counted by torch (``device="cpu"``) as integers, so its point
estimate and bounds are held bit for bit, for odd and even ``n`` and past
``n = 2048``, where the JAX C-index counts with a Fenwick tree.
"""

import json

import numpy as np
import pandas as pd
import pytest

from multimodalbrainsurvival_torch.cli import evaluate_scores
from multimodalbrainsurvival_torch.ops import survival
from multimodalbrainsurvival_tpu.cli import evaluate_scores as jax_evaluate_scores
from multimodalbrainsurvival_tpu.ops import survival as jax_survival

RTOL = 1e-12


def _cohort(n, seed, censored=0.4):
    rng = np.random.default_rng(seed)
    times = np.round(rng.exponential(30.0, n) / 3.0) * 3.0 + 1.0
    events = rng.random(n) > censored
    scores = np.round(rng.normal(size=n), 1)  # ties in the risk scores
    return times, events, scores


def _assert_same(got, want, path="", exact=()):
    """Equal structure; floats at RTOL (the names in ``exact`` bit for
    bit), everything else equal."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}", exact)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]", exact)
    elif isinstance(want, float) and not isinstance(want, bool):
        if path.split(".")[-1] in exact:
            assert got == want or (np.isnan(got) and np.isnan(want)), path
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=path)
    else:
        assert got == want, path


def _assert_arrays(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_kaplan_meier_matches_jax(seed):
    t, e, _ = _cohort(60, seed)
    got, want = survival.kaplan_meier(t, e, alpha=0.1), jax_survival.kaplan_meier(t, e, alpha=0.1)
    for field in ("time", "survival", "at_risk", "observed", "ci_lower", "ci_upper"):
        _assert_arrays(getattr(got, field), getattr(want, field))
    at = np.linspace(0, t.max() + 5, 23)
    _assert_arrays(got.step_function(at), want.step_function(at))
    _assert_arrays(got.left_limit(t), want.left_limit(t))
    assert got.median_survival == want.median_survival
    flat = survival.kaplan_meier(t, np.zeros_like(e))
    assert flat.time.size == 0 and flat.median_survival == float("inf")


@pytest.mark.parametrize("k", [2, 3])
def test_logrank_and_risk_groups_match_jax(k):
    t, e, s = _cohort(80, 2)
    groups = np.arange(80) % k
    got, want = survival.logrank_test(t, e, groups), jax_survival.logrank_test(t, e, groups)
    np.testing.assert_allclose([got.chi2, got.p_value], [want.chi2, want.p_value], rtol=RTOL)
    assert got.df == want.df
    _assert_arrays(got.observed, want.observed)
    _assert_arrays(got.expected, want.expected)
    for cutoff in (None, 0.3):
        (g1, c1), (g2, c2) = survival.risk_groups(s, cutoff), jax_survival.risk_groups(s, cutoff)
        _assert_arrays(g1, g2)
        assert c1 == c2


def test_time_dependent_metrics_match_jax():
    t, e, s = _cohort(90, 3)
    taus = survival.default_eval_times(t, e)
    _assert_arrays(taus, jax_survival.default_eval_times(t, e))
    assert taus.size >= 2
    surv = np.exp(-np.outer(np.exp(0.3 * s), taus / 40.0))
    ct, ce, _ = _cohort(70, 4)
    for kw in ({}, {"censor_times": ct, "censor_events": ce}):
        _assert_arrays(survival.brier_score(t, e, surv, taus, **kw),
                       jax_survival.brier_score(t, e, surv, taus, **kw))
        np.testing.assert_allclose(
            survival.integrated_brier_score(t, e, surv, taus, **kw),
            jax_survival.integrated_brier_score(t, e, surv, taus, **kw), rtol=RTOL)
        (auc, mean), (jauc, jmean) = (survival.cumulative_dynamic_auc(t, e, s, taus, **kw),
                                      jax_survival.cumulative_dynamic_auc(t, e, s, taus, **kw))
        _assert_arrays(auc, jauc)
        np.testing.assert_allclose(mean, jmean, rtol=RTOL)
    with pytest.raises(ValueError, match="beyond follow-up"):
        survival.brier_score(t, e, surv[:, :1], [t.max() + 1.0])


@pytest.mark.parametrize("ties", ["breslow", "efron"])
def test_cox_ph_matches_jax(ties):
    t, e, s = _cohort(120, 5)
    rng = np.random.default_rng(6)
    X = np.column_stack([s + 0.3 * rng.normal(size=120), rng.integers(0, 2, 120)])
    got = survival.cox_ph(t, e, X, names=["score", "grp"], ties=ties)
    want = jax_survival.cox_ph(t, e, X, names=["score", "grp"], ties=ties)
    for field in ("coef", "se", "z", "p_value", "hr", "hr_ci_lower", "hr_ci_upper",
                  "baseline_time", "baseline_cumhaz"):
        _assert_arrays(getattr(got, field), getattr(want, field))
    for field in ("log_likelihood", "ll_null", "lr_chi2", "lr_p", "score_chi2", "score_p"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=RTOL)
    assert (got.n, got.n_events, got.n_iter, got.converged) == \
        (want.n, want.n_events, want.n_iter, want.converged)
    _assert_same(got.summary_rows(), want.summary_rows())
    at = np.array([1.0, 10.0, 30.0, 200.0])
    _assert_arrays(got.predict_survival(X[:7], at), want.predict_survival(X[:7], at))
    _assert_arrays(got.predict_survival(X[0], at), want.predict_survival(X[0], at))
    with pytest.raises(ValueError, match="constant"):
        survival.cox_ph(t, e, np.ones((120, 1)))


@pytest.mark.parametrize("n, n_boot", [(37, 400), (64, 400), (2049, 3)])
def test_bootstrap_concordance_bit_for_bit(n, n_boot):
    """Odd and even n, and n past 2048, where the JAX C-index counts with
    a Fenwick tree: the counts are integers, so every number is equal."""
    t, e, s = _cohort(n, 7)
    got = survival.bootstrap_concordance(t, s, e, n_boot=n_boot, seed=3, device="cpu")
    want = jax_survival.bootstrap_concordance(t, s, e, n_boot=n_boot, seed=3)
    assert got == want


def test_bootstrap_skips_resamples_without_a_pair_and_chunks_alike():
    """Mostly censored: some resamples hold no comparable pair and are
    skipped, as in JAX; a small memory budget (one resample a chunk) counts
    the same pairs."""
    t, e, s = _cohort(9, 8, censored=0.6)
    got = survival.bootstrap_concordance(t, s, e, n_boot=300, seed=1, device="cpu")
    want = jax_survival.bootstrap_concordance(t, s, e, n_boot=300, seed=1)
    assert got == want and got["n_boot"] == 193
    # no comparable pair at all: no draw, NaN bounds in both
    t, e, s = _cohort(9, 8, censored=1.0)
    _assert_same(survival.bootstrap_concordance(t, s, e, n_boot=20, device="cpu"),
                 jax_survival.bootstrap_concordance(t, s, e, n_boot=20),
                 exact=("c_index", "ci_lower", "ci_upper"))
    idx = survival.resample_indices(9, 50, 2)
    np.testing.assert_array_equal(
        survival.bootstrap_pair_counts(t, s, e, idx, "cpu", memory_budget=1),
        survival.bootstrap_pair_counts(t, s, e, idx, "cpu"))


@pytest.mark.parametrize("n", [7, 8])
def test_resample_indices_are_the_loops_draws(n):
    rng = np.random.default_rng(5)
    want = np.stack([rng.integers(0, n, size=n) for _ in range(4)])
    np.testing.assert_array_equal(survival.resample_indices(n, 4, 5), want)


# --- evaluate_scores ------------------------------------------------------------


def _frame(path, n, seed, ids=None):
    t, e, s = _cohort(n, seed)
    pd.DataFrame({"id": ids or [f"c{i}" for i in range(n)], "score": s,
                  "survival_months": t, "vital_status": e.astype(int)}).to_csv(path)
    return str(path)


def _run_both(tmp_path, argv):
    """Each stack's CLI into its own output directory; returns the two."""
    out = {}
    for name, main, extra in (("jax", jax_evaluate_scores.main, []),
                              ("torch", evaluate_scores.main, ["--device", "cpu"])):
        out[name] = tmp_path / f"eval_{name}"
        main(argv + ["--output_dir", str(out[name])] + extra)
    return out["jax"], out["torch"]


def _assert_outputs_match(want_dir, got_dir, name):
    want = json.loads((want_dir / f"evaluation_{name}.json").read_text())
    got = json.loads((got_dir / f"evaluation_{name}.json").read_text())
    _assert_same(got, want, exact=("c_index", "ci_lower", "ci_upper"))
    for table in (f"km_{name}.csv", f"cox_{name}.csv"):
        w, g = (want_dir / table).read_text(), (got_dir / table).read_text()
        assert g.splitlines()[0] == w.splitlines()[0], table
        wf, gf = pd.read_csv(want_dir / table), pd.read_csv(got_dir / table)
        assert len(gf) == len(wf), table
        for col in wf:
            if wf[col].dtype.kind == "f":
                np.testing.assert_allclose(gf[col], wf[col], rtol=RTOL, err_msg=col)
            else:
                assert list(gf[col]) == list(wf[col]), col
    return got


@pytest.mark.parametrize("with_train", [False, True])
def test_evaluate_scores_matches_jax(tmp_path, with_train):
    val = _frame(tmp_path / "val_df.csv", 70, 10)
    argv = ["--scores", val, "--n_boot", "300", "--seed", "4"]
    if with_train:
        argv += ["--train_scores", _frame(tmp_path / "train_df.csv", 90, 11)]
    want_dir, got_dir = _run_both(tmp_path, argv)
    got = _assert_outputs_match(want_dir, got_dir, "val_df")
    assert got["cutoff_source"] == ("train_median" if with_train else "self_median")
    assert got["time_dependent"]["calibration"] == ("train_cox" if with_train else "self_cox")


def test_evaluate_scores_cohort_covariates_match_jax(tmp_path):
    """``--cohort --covariates`` with a text column (three levels, coded as
    ``pd.get_dummies(drop_first=True)`` codes them), a number column with a
    NaN (its row dropped before the coding), a case that repeats (the
    first kept) and a case with no score (dropped by the join)."""
    n = 60
    val = _frame(tmp_path / "val_df.csv", n, 12)
    rng = np.random.default_rng(13)
    age = rng.normal(60, 10, n + 1).round(1)
    age[5] = np.nan
    cohort = pd.DataFrame({
        "case": [f"c{i}" for i in range(n)] + ["c3"],
        "age": age, "grade": rng.choice(["II", "III", "IV"], n + 1),
        "site": rng.choice(["left", "right"], n + 1)})
    cohort = pd.concat([cohort, pd.DataFrame({"case": ["zz"], "age": [50.0],
                                              "grade": ["II"], "site": ["left"]})])
    cohort.to_csv(tmp_path / "cohort.csv", index=False)
    argv = ["--scores", val, "--n_boot", "200", "--cohort", str(tmp_path / "cohort.csv"),
            "--covariates", "grade,age,site"]
    want_dir, got_dir = _run_both(tmp_path, argv)
    got = _assert_outputs_match(want_dir, got_dir, "val_df")
    names = [r["covariate"] for r in got["cox_adjusted"]["covariates"]]
    assert names == ["score_per_sd", "age", "grade_III", "grade_IV", "site_right"]
    assert got["cox_adjusted"]["n_dropped_missing"] == 1


def test_evaluate_scores_eval_times_and_plot(tmp_path):
    val = _frame(tmp_path / "val_df.csv", 50, 14)
    argv = ["--scores", val, "--n_boot", "100", "--eval_times", "30,10,20", "--plot", "1"]
    want_dir, got_dir = _run_both(tmp_path, argv)
    got = _assert_outputs_match(want_dir, got_dir, "val_df")
    assert got["time_dependent"]["eval_times"] == [10.0, 20.0, 30.0]
    assert (got_dir / "km_val_df.png").stat().st_size > 0


def test_evaluate_scores_errors(tmp_path, monkeypatch):
    val = _frame(tmp_path / "val_df.csv", 20, 15)
    with pytest.raises(SystemExit, match="--covariates needs --cohort"):
        evaluate_scores.main(["--scores", val, "--covariates", "age", "--device", "cpu"])
    pd.DataFrame({"id": ["a"], "score": [1.0]}).to_csv(tmp_path / "bad.csv")
    with pytest.raises(SystemExit, match="not a savescore frame"):
        evaluate_scores.main(["--scores", str(tmp_path / "bad.csv"), "--device", "cpu"])
    # --plot 1 without matplotlib stops before any frame is evaluated
    monkeypatch.setattr(evaluate_scores.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(SystemExit, match="matplotlib"):
        evaluate_scores.main(["--scores", val, "--plot", "1", "--device", "cpu",
                              "--output_dir", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()
