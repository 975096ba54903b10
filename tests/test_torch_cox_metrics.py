"""The port's eval Cox loss and survival metrics against the JAX package.

Cox: both ``reference_parity`` modes on ties, all-censored batches and
padded (masked) rows, float32, ``rtol=1e-6``. Metrics: the C-index and the
per-id score frame of ``survival_ci`` (numpy in the port, pandas in the JAX
package), and the O(n log n) pair counting against the quadratic one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.ops import metrics as M
from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss
from multimodalbrainsurvival_tpu.ops import metrics as jax_metrics
from multimodalbrainsurvival_tpu.ops.cox import (
    cox_partial_likelihood_loss as jax_cox,
)


def _batch(case, n=12, seed=0):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=n).astype(np.float32)
    times = rng.uniform(1, 100, n).astype(np.float32)
    events = rng.integers(0, 2, n).astype(np.float32)
    mask = None
    if case == "ties":
        times = rng.integers(1, 4, n).astype(np.float32)
    elif case == "all_censored":
        events[:] = 0
    elif case == "masked":
        mask = np.arange(n) < n - 4
        scores[~mask] = 50.0  # pads must not move the stabilizer
    elif case == "masked_ties":
        times = rng.integers(1, 4, n).astype(np.float32)
        mask = rng.random(n) < 0.6
    elif case == "all_masked":
        mask = np.zeros(n, bool)
    return scores, times, events, mask


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize(
    "case", ["plain", "ties", "all_censored", "masked", "masked_ties", "all_masked"]
)
def test_cox_loss_matches_jax(case, parity):
    s, t, e, m = _batch(case)
    want = float(jax_cox(jnp.asarray(s), jnp.asarray(t), jnp.asarray(e),
                         None if m is None else jnp.asarray(m),
                         reference_parity=parity))
    got = cox_partial_likelihood_loss(
        torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(e),
        None if m is None else torch.from_numpy(m), reference_parity=parity,
    )
    assert got.dtype == torch.float32 and np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-7)


def test_cox_loss_padding_equals_unpadded():
    s, t, e, _ = _batch("plain", n=8, seed=4)
    pad = np.zeros(3, np.float32)
    mask = np.r_[np.ones(8, bool), np.zeros(3, bool)]
    for parity in (True, False):
        full = cox_partial_likelihood_loss(
            torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(e),
            reference_parity=parity)
        padded = cox_partial_likelihood_loss(
            *(torch.from_numpy(np.r_[a, pad]) for a in (s, t, e)),
            torch.from_numpy(mask), reference_parity=parity)
        assert padded.item() == pytest.approx(full.item(), rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_survival_ci_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    ids = [f"case{i}" for i in rng.integers(0, 15, n)]
    outputs = rng.normal(size=(n, 1)).astype(np.float32)
    per_id = {i: (rng.uniform(1, 100), float(rng.integers(0, 2))) for i in set(ids)}
    months = np.array([per_id[i][0] for i in ids], np.float32)
    status = np.array([per_id[i][1] for i in ids], np.float32)
    ci, frame = M.survival_ci(outputs, ids, months, status)
    want_ci, want = jax_metrics.survival_ci(outputs, ids, months, status)
    assert ci == pytest.approx(want_ci, abs=1e-12)
    assert list(frame) == list(want.columns)
    assert frame["id"] == list(want["id"])
    for col in ("score", "survival_months", "vital_status"):
        np.testing.assert_allclose(frame[col], want[col].to_numpy(), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_concordance_nlogn_matches_quadratic_and_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    t = rng.integers(0, 40, n).astype(np.float64)  # many tied times
    r = np.round(rng.normal(size=n), 1)  # many tied risks
    e = rng.random(n) < 0.5
    quad = M._concordance_quadratic(t, r, e, 1e-8)
    assert M._concordance_nlogn(t, r, e, 1e-8) == pytest.approx(quad, abs=1e-12)
    assert quad == pytest.approx(
        jax_metrics._concordance_quadratic(t, r, e, 1e-8), abs=1e-12)
    # lifelines-style call: a survival ordering, so risk r is passed as -r
    assert M.concordance_index(t, -r, e) == pytest.approx(
        jax_metrics.concordance_index_censored(e, t, r), abs=1e-12)


def test_group_mean_matches_jax():
    rng = np.random.default_rng(7)
    ids = [f"w{i}" for i in rng.integers(0, 6, 30)]
    vals = rng.normal(size=(30, 3))
    uids, means = M._group_mean(vals, ids)
    want_ids, want = jax_metrics._group_mean(vals, ids)
    assert uids == list(want_ids)
    np.testing.assert_allclose(means, want, rtol=1e-12)
