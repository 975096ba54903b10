"""Host-side survival metrics on numpy alone.

The port's own copy of ``multimodalbrainsurvival_tpu/ops/metrics.py:37-207``:
Harrell's concordance index (the lifelines / sksurv definitions, counted
natively) and the per-id score frame of ``get_survival_CI``
(``2_HistoPath_train.py:184-209``). The JAX version groups with pandas; this
one uses numpy, and a frame is an ordered ``{column: list}`` dict.

comparable pairs (i, j):
  - ``t_i < t_j`` and ``event_i``, or
  - ``t_i == t_j`` and ``event_i`` and ``not event_j``;
concordance: 1 if the higher-risk sample is the shorter-lived, 0.5 for risk
ties (within ``tied_tol``), 0 otherwise.

``nllsurv_ci`` and ``classification_scores`` come with the ``survival_bin``
and ``classification`` tasks (ROADMAP.md, queue 1, item 1).
"""

from __future__ import annotations

import numpy as np


def _concordance_quadratic(t, r, e, tied_tol):
    ti = t[:, None]
    tj = t[None, :]
    ei = e[:, None]
    ej = e[None, :]
    comparable = (ei & (ti < tj)) | (ei & ~ej & (ti == tj))

    ri = r[:, None]
    rj = r[None, :]
    tied = np.abs(ri - rj) <= tied_tol
    concordant = comparable & (ri > rj) & ~tied
    tied_pairs = comparable & tied

    num_comparable = comparable.sum()
    if num_comparable == 0:
        return np.nan
    return float((concordant.sum() + 0.5 * tied_pairs.sum()) / num_comparable)


class _Fenwick:
    def __init__(self, n: int):
        self.tree = np.zeros(n + 1, np.int64)
        self.n = n

    def add(self, i: int) -> None:
        i += 1
        while i <= self.n:
            self.tree[i] += 1
            i += i & (-i)

    def prefix(self, i: int) -> int:
        # count of inserted ranks < i
        s = 0
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return int(s)


def _concordance_nlogn(t, r, e, tied_tol):
    """O(n log n) pair counting with the same pairwise tie band
    ``|r_i - r_j| <= tied_tol`` as the quadratic counting: ascend unique
    times; a Fenwick tree over the exact risk values holds every sample with
    a strictly later time, and same-time event-vs-censored pairs are counted
    within each time group."""
    uniq = np.unique(r)
    ranks = np.searchsorted(uniq, r)

    by_time = np.argsort(t, kind="stable")
    groups: list[np.ndarray] = []
    start = 0
    for k in range(1, len(t) + 1):
        if k == len(t) or t[by_time[k]] != t[by_time[start]]:
            groups.append(by_time[start:k])
            start = k

    bit = _Fenwick(len(uniq))
    inserted = 0
    conc = tied = total = 0
    for g in reversed(groups):
        g_event = g[e[g]]
        g_cens = g[~e[g]]
        for i in g_event:
            lo = int(np.searchsorted(uniq, r[i] - tied_tol, side="left"))
            hi = int(np.searchsorted(uniq, r[i] + tied_tol, side="right"))
            below = bit.prefix(lo)
            at = bit.prefix(hi) - below
            conc += below
            tied += at
            total += inserted
        if len(g_event) and len(g_cens):
            cr = np.sort(r[g_cens])
            for i in g_event:
                lo = np.searchsorted(cr, r[i] - tied_tol, side="left")
                hi = np.searchsorted(cr, r[i] + tied_tol, side="right")
                conc += int(lo)
                tied += int(hi - lo)
                total += len(cr)
        for i in g:
            bit.add(int(ranks[i]))
        inserted += len(g)
    if total == 0:
        return np.nan
    return float((conc + 0.5 * tied) / total)


def _concordance_from_risk(
    times: np.ndarray, risks: np.ndarray, events: np.ndarray,
    tied_tol: float = 1e-8,
) -> float:
    t = np.asarray(times, dtype=np.float64).reshape(-1)
    r = np.asarray(risks, dtype=np.float64).reshape(-1)
    e = np.asarray(events).reshape(-1).astype(bool)
    if t.shape[0] < 2:
        return np.nan
    if t.shape[0] <= 2048:  # vectorized O(n²) wins at eval-set sizes
        return _concordance_quadratic(t, r, e, tied_tol)
    return _concordance_nlogn(t, r, e, tied_tol)


def concordance_index(
    times: np.ndarray, predicted: np.ndarray, events: np.ndarray
) -> float:
    """lifelines-style call: ``predicted`` is a predicted survival ordering
    (higher = longer life), so risk = ``-predicted``."""
    return _concordance_from_risk(
        times, -np.asarray(predicted, np.float64), events
    )


def _group_mean(values: np.ndarray, ids: list) -> tuple[list, np.ndarray]:
    """Per-id mean of ``values`` (rows); ids come back sorted and unique, as
    ``DataFrame.groupby(sort=True)`` returns them."""
    vals = np.asarray(values)
    if vals.ndim == 1:
        vals = vals[:, None]
    uids, inverse = np.unique(np.asarray(ids), return_inverse=True)
    sums = np.zeros((len(uids), vals.shape[1]), np.float64)
    np.add.at(sums, inverse.reshape(-1), vals)
    counts = np.bincount(inverse.reshape(-1), minlength=len(uids))
    return uids.tolist(), sums / counts[:, None]


def survival_ci(
    outputs: np.ndarray,
    ids: list,
    survival_months: np.ndarray,
    vital_status: np.ndarray,
) -> tuple[float, dict]:
    """Per-id mean Cox score → Harrell C-index + the reference's score frame
    (columns ``id, score, survival_months, vital_status``; labels from the
    last occurrence of each id)."""
    outputs = np.asarray(outputs)
    scores = outputs[:, 0] if outputs.ndim == 2 else outputs.reshape(-1)
    uids, mean_scores = _group_mean(scores, ids)
    mean_scores = mean_scores[:, 0]
    lookup_m = dict(zip(ids, np.asarray(survival_months).reshape(-1)))
    lookup_v = dict(zip(ids, np.asarray(vital_status).reshape(-1)))
    months = np.array([lookup_m[i] for i in uids])
    status = np.array([lookup_v[i] for i in uids])
    ci = concordance_index(months, -mean_scores, status)
    frame = {
        "id": uids,
        "score": mean_scores.tolist(),
        "survival_months": months.tolist(),
        "vital_status": status.tolist(),
    }
    return ci, frame
