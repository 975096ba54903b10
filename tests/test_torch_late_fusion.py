"""The port's late fusion (``ops/coxnet.py``, ``merge_scores``,
``concat_features``, ``late_fusion``) against the JAX package, on the CPU.

One JAX ``fit_coxnet`` per file (it compiles a solve for every fold size):
the JAX ``late_fusion`` CLI's, on the merged frames of a seeded cohort
with ties in time. The port's fit on the same rows is held to it at
``lambdas`` rtol 1e-6 (both take the null gradient in float32), and
``cv_mean`` and ``betas_path`` at rtol 1e-4 / atol 1e-6 (float32 sums in
another order, after 20 x 500 FISTA steps: the fixture runs both CLIs on a
path of ``LATE_N_LAMBDA`` λ values), with the same λ.min where the
JAX curve's two lowest points lie further apart than that. The analytic
gradient is held to ``jax.grad`` of the JAX ``_npll`` with ties and on a
fold's rows; the batched, masked solve to a loop of single problems; the
path to the independent glmnet algorithm (``tests/glmnet_oracle.py``) and
to the KKT conditions. The CLIs' frames equal the JAX CLIs' (headers and
row order exact, values at rtol 1e-6, the late-fusion scores at 1e-4).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import concat_features as port_concat
from multimodalbrainsurvival_torch.cli import late_fusion as port_late
from multimodalbrainsurvival_torch.cli import merge_scores as port_merge
from multimodalbrainsurvival_torch.data import FeatureTableDataset
from multimodalbrainsurvival_torch.frames import read_frame, write_frame
from multimodalbrainsurvival_torch.ops import coxnet as port_coxnet
from multimodalbrainsurvival_tpu.cli import concat_features as jax_concat
from multimodalbrainsurvival_tpu.cli import late_fusion as jax_late
from multimodalbrainsurvival_tpu.cli import merge_scores as jax_merge
from multimodalbrainsurvival_tpu.ops.coxnet import _npll
from tests.glmnet_oracle import glmnet_cox_path

CPU = torch.device("cpu")
COX_RTOL, COX_ATOL = 1e-4, 1e-6


def _score_frames(root, split, n, seed):
    """A histo and an RNA savescore frame (index column, ``id, score,
    survival_months, vital_status``) over overlapping, shuffled cases;
    times on a 3-month grid (ties), ~40% censored; the pathology score
    carries the risk, the RNA score is noise, so the CV curve has a clear
    interior minimum (the train split's seed is picked for that)."""
    rng = np.random.default_rng(seed)
    cases = [f"{split}{i:03d}" for i in range(n)]
    risk = rng.normal(size=n)
    path = risk * 0.8 + rng.normal(size=n) * 0.6
    rna = rng.normal(size=n) * 0.8
    months = np.ceil(rng.exponential(40 * np.exp(-risk)) / 3) * 3
    status = (rng.uniform(size=n) > 0.4).astype(int)
    keep_p = rng.permutation(n)[: n - 3]   # each frame misses a few cases
    keep_r = rng.permutation(n)[: n - 2]
    files = {}
    for name, idx, score in (("path", keep_p, path), ("rna", keep_r, rna)):
        frame = {"id": [cases[i] for i in idx], "score": score[idx].tolist(),
                 "survival_months": months[idx].tolist(),
                 "vital_status": status[idx].tolist()}
        files[name] = os.path.join(root, f"{name}_{split}.csv")
        write_frame(files[name], frame)
    return files


#: the λ path of the CLI fixture's fits (both stacks): shorter than the
#: CLIs' 50, so the JAX fit's 11 problems stay a few seconds' work; its
#: λ.min choice stays decided (``test_fit_coxnet_matches_jax``)
LATE_N_LAMBDA = 20


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The coxnet fits and the plain K1 runs here are tiny ops: on several
    threads beside other test processes they wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def late(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for cli, fit in ((jax_late, jax_late.fit_coxnet), (port_late, port_late.fit_coxnet)):
            mp.setattr(cli, "fit_coxnet", functools.partial(fit, n_lambda=LATE_N_LAMBDA))
        return _late_fusion_runs(tmp_path_factory)


def _late_fusion_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("late"))
    out = {"root": root}
    for split, n, seed in (("train", 125, 2), ("val", 40, 1)):
        files = _score_frames(root, split, n, seed)
        for stack, merge in (("jax", jax_merge.merge_scores), ("port", port_merge.merge_scores)):
            path = os.path.join(root, f"{stack}_combined_{split}.csv")
            merge(files["path"], files["rna"], path)
            out[f"{stack}_{split}"] = path
    for stack in ("jax", "port"):
        os.makedirs(os.path.join(root, stack), exist_ok=True)
    out["jax"] = jax_late.run_late_fusion(out["jax_train"], out["jax_val"],
                                          os.path.join(root, "jax"), seed=3)
    out["port"] = port_late.run_late_fusion(out["port_train"], out["port_val"],
                                            os.path.join(root, "port"), seed=3,
                                            device="cpu")
    return out


def _cohort(n=120, p=2, seed=5, grid=4.0, censor=0.4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    beta = np.array([0.9, -0.6, 0.4, 0.0, 0.0])[:p]
    t = (np.ceil(rng.exponential(np.exp(-X @ beta)) * grid) / grid).astype(np.float32)
    e = (rng.uniform(size=n) > censor).astype(np.float32)
    return X, t, e


def _assert_frames_equal(got_path, want_path, rtol):
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        if want[c].dtype.kind in "fiu":
            np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                       want[c].to_numpy(np.float64), rtol=rtol, atol=0)
        else:
            assert got[c].tolist() == want[c].tolist(), c


def test_fit_coxnet_matches_jax(late):
    jfit, pfit = late["jax"]["fit"], late["port"]["fit"]
    np.testing.assert_allclose(pfit.lambdas, jfit.lambdas, rtol=1e-6)
    np.testing.assert_allclose(pfit.cv_mean, jfit.cv_mean, rtol=COX_RTOL, atol=COX_ATOL)
    np.testing.assert_allclose(pfit.betas_path, jfit.betas_path, rtol=COX_RTOL,
                               atol=COX_ATOL)
    # the choice of λ.min is decided: the JAX curve's two lowest points lie
    # further apart than the tolerance
    lowest = np.sort(jfit.cv_mean[np.isfinite(jfit.cv_mean)])[:2]
    assert lowest[1] - lowest[0] > COX_RTOL * abs(lowest[0]) + COX_ATOL, lowest
    # the same point of the path (the λ values themselves agree at 1e-6)
    assert list(pfit.lambdas).index(pfit.lambda_min) == \
        list(jfit.lambdas).index(jfit.lambda_min)
    np.testing.assert_allclose(pfit.beta, jfit.beta, rtol=COX_RTOL, atol=COX_ATOL)
    assert pfit.intercept_shift == pytest.approx(jfit.intercept_shift, rel=COX_RTOL,
                                                 abs=COX_ATOL)
    assert pfit.stats["graph_replays"] == 0 and pfit.stats["problems"] == 11


@pytest.mark.parametrize("rows", ["all", "fold"])
def test_npll_and_gradient_match_jax_with_ties(rows):
    """The loss and its analytic gradient against the JAX ``_npll`` and
    ``jax.grad`` of it, on a tied cohort, for the full data and for a
    fold's rows (the masked problem against JAX on the subset)."""
    X, t, e = _cohort(n=60, p=3, grid=2.0)
    assert len(np.unique(t)) < len(t) // 2
    mask = np.ones(60, bool) if rows == "all" else np.arange(60) % 3 != 1
    problems = port_coxnet.CoxProblems(X, t, e, mask[None], CPU)
    grad = jax.grad(_npll)
    for beta in (np.zeros(3), np.array([0.4, -0.3, 0.2]), np.array([-1.2, 0.8, 1.5])):
        beta = beta.astype(np.float32)
        args = (jnp.asarray(beta), jnp.asarray(X[mask]), jnp.asarray(t[mask]),
                jnp.asarray(e[mask]))
        b = torch.as_tensor(beta)[None]
        np.testing.assert_allclose(problems.npll(b).numpy()[0], float(_npll(*args)),
                                   rtol=1e-6)
        np.testing.assert_allclose(problems.grad(b).numpy()[0], np.asarray(grad(*args)),
                                   rtol=1e-5, atol=1e-7)


def test_batched_masked_solve_matches_single_problems():
    """The batch of masked problems (three folds and the full fit) gives
    each problem's path as a solve of that problem alone does."""
    X, t, e = _cohort(n=45, p=2)
    masks = np.stack([np.arange(45) % 3 != f for f in range(3)] + [np.ones(45, bool)])
    lambdas = np.geomspace(0.3, 0.003, 6)
    batch = port_coxnet.solve_path(
        port_coxnet.FistaSolver(port_coxnet.CoxProblems(X, t, e, masks, CPU), 1.0, 60), lambdas)
    for j, m in enumerate(masks):
        alone = port_coxnet.solve_path(
            port_coxnet.FistaSolver(port_coxnet.CoxProblems(X[m], t[m], e[m], np.ones((1, m.sum()),
                                                                                 bool), CPU),
                               1.0, 60), lambdas)
        np.testing.assert_allclose(batch[:, j], alone[:, 0], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("tie_grid,alpha", [(None, 1.0), (8, 0.5)])
def test_path_matches_glmnet_algorithm(tie_grid, alpha):
    """As ``tests/test_coxnet_glmnet_oracle.py`` holds the JAX fit: the
    path's betas against glmnet's coordinate descent on IRLS (λ scaled by
    n_events / n), with and without heavy ties."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(100, 3)).astype(np.float32)
    t = rng.exponential(np.exp(-X @ np.array([0.9, -0.7, 0.0])))
    if tie_grid:
        edges = np.quantile(t, np.linspace(0, 1, tie_grid + 1))
        t = edges[np.clip(np.searchsorted(edges, t), 1, tie_grid)]
    t = t.astype(np.float32)
    e = (rng.uniform(size=100) > 0.3).astype(np.float32)
    fit = port_coxnet.fit_coxnet(X, t, e, alpha=alpha, n_lambda=12, n_folds=2, seed=0,
                                 max_iter=800, device=CPU)
    sd = np.where(X.std(0) > 0, X.std(0), 1.0)
    Xs = (X - X.mean(0)) / sd
    oracle = glmnet_cox_path(Xs, t, e, fit.lambdas * float(e.sum()) / len(t), alpha=alpha)
    assert np.abs(fit.betas_path * sd - oracle).max() < 5e-3


def test_kkt_conditions_along_path(late):
    """At every fourth λ the full fit's β satisfies the lasso's subgradient
    conditions, with the port's own gradient on the standardized X."""
    frame = read_frame(late["port_train"])
    X = np.stack([frame["path_score"], frame["rna_score"]], 1).astype(np.float32)
    t = np.asarray(frame["survival_months"], np.float32)
    e = np.asarray(frame["vital_status"], np.float32)
    fit = late["port"]["fit"]
    sd = np.where(X.std(0) > 0, X.std(0), 1.0)
    problems = port_coxnet.CoxProblems((X - X.mean(0)) / sd, t, e,
                                       np.ones((1, len(t)), bool), CPU)
    active_seen = 0
    for i in range(0, len(fit.lambdas), 4):
        lam = float(fit.lambdas[i])
        b = (fit.betas_path[i] * sd).astype(np.float32)
        g = problems.grad(torch.as_tensor(b)[None]).numpy()[0]
        tol = max(2e-3, 0.02 * lam)
        active = np.abs(b) > 1e-5
        assert np.all(np.abs(g[active] + lam * np.sign(b[active])) < tol), (i, g, b)
        assert np.all(np.abs(g[~active]) <= lam + tol), (i, g, b)
        active_seen += int(active.sum())
    assert active_seen > 0


def test_degenerate_cv_warns_and_takes_largest_lambda():
    """One event in 12 rows: no fold has events on both sides, so the fit
    warns as the JAX one does and takes the largest λ."""
    X, t, _ = _cohort(n=12, p=2)
    e = np.zeros(12, np.float32)
    e[5] = 1.0
    with pytest.warns(UserWarning, match="coxnet CV degenerate"):
        fit = port_coxnet.fit_coxnet(X, t, e, n_folds=2, n_lambda=5, max_iter=20,
                                     device=CPU)
    assert np.all(np.isnan(fit.cv_mean))
    assert fit.lambda_min == fit.lambdas[0]
    np.testing.assert_array_equal(fit.beta, 0.0)


@pytest.mark.parametrize("split", ["train", "val"])
def test_merge_scores_frames_match_jax(late, split):
    with open(late[f"port_{split}"]) as f:
        assert f.readline().strip() == "case,path_score,survival_months,vital_status,rna_score"
    _assert_frames_equal(late[f"port_{split}"], late[f"jax_{split}"], rtol=1e-6)


@pytest.mark.parametrize("split", ["train", "val"])
def test_late_fusion_frames_match_jax(late, split):
    name = f"model_late_{split}.csv"
    _assert_frames_equal(os.path.join(late["root"], "port", name),
                         os.path.join(late["root"], "jax", name), rtol=1e-4)
    assert late["port"][split]["ci"] == pytest.approx(late["jax"][split]["ci"], abs=1e-12)


def test_concat_features_matches_jax_and_feeds_feature_train(tmp_path):
    """The extract CLIs' files (cases with an index column and a ``"0"``
    header; features by ``np.savetxt``, no header) joined as the JAX CLI
    joins them: columns, row order (the patient info's) and values; the
    table reads as ``feature_train``'s dataset, 2 x 6 features wide."""
    rng = np.random.default_rng(2)
    info_cases = [f"c{i}" for i in (4, 0, 2, 7, 1, 5)]
    info = {"case": info_cases, "survival_months": [12.5, 3.0, 40.25, 7.0, 1.5, 60.0],
            "vital_status": [1, 0, 1, 1, 0, 0], "grade": ["a", "b", "a", "b", "a", "b"]}
    write_frame(str(tmp_path / "info.csv"), info, index=False)
    for prefix, cases in (("rna", ["c0", "c1", "c2", "c3", "c4", "c5"]),
                          ("pathology", ["c5", "c4", "c2", "c1", "c0", "c9"])):
        write_frame(str(tmp_path / f"{prefix}_cases.csv"), {"0": cases})
        np.savetxt(tmp_path / f"{prefix}_features.csv",
                   rng.normal(size=(len(cases), 6)).astype(np.float32), delimiter=",")
    args = [str(tmp_path / n) for n in ("rna_cases.csv", "rna_features.csv",
                                        "pathology_cases.csv", "pathology_features.csv",
                                        "info.csv")]
    jax_concat.concat_features(*args, str(tmp_path / "jax.csv"))
    port_concat.main(["--rna_cases", args[0], "--rna_features", args[1],
                      "--pathology_cases", args[2], "--pathology_features", args[3],
                      "--patientinfo", args[4], "--output", str(tmp_path / "port.csv")])
    _assert_frames_equal(str(tmp_path / "port.csv"), str(tmp_path / "jax.csv"), rtol=1e-6)
    header = open(tmp_path / "port.csv").readline().strip().split(",")
    assert header[:5] == ["case", "survival_months", "vital_status", "feature_0_x",
                          "feature_1_x"]
    assert header[-1] == "feature_5_y" and len(header) == 15
    ds = FeatureTableDataset(str(tmp_path / "port.csv"))
    assert ds.features.shape == (5, 12)
    assert ds.case == ["c4", "c0", "c2", "c1", "c5"]
