"""Host-side survival and classification metrics on numpy alone.

The port's own copy of ``multimodalbrainsurvival_tpu/ops/metrics.py:37-266``:
Harrell's concordance index (the lifelines / sksurv definitions, counted
natively) and the per-id score frames of ``get_survival_CI``,
``get_classification_scores`` and ``get_nllsurv_CI``
(``2_HistoPath_train.py:150-280``). The JAX version groups with pandas and
scores classification with sklearn; this one uses numpy for both, and a
frame is an ordered ``{column: list}`` dict.

comparable pairs (i, j):
  - ``t_i < t_j`` and ``event_i``, or
  - ``t_i == t_j`` and ``event_i`` and ``not event_j``;
concordance: 1 if the higher-risk sample is the shorter-lived, 0.5 for risk
ties (within ``tied_tol``), 0 otherwise.

Classification scores follow sklearn's definitions: accuracy is the share
of right argmax predictions; F1 is the binary F1 of class 1 for two
classes (0 when there is no true and no predicted positive, sklearn's
``zero_division`` default) and the micro F1 for more, which for one label
per id is the accuracy; the AUC of two classes is the Mann-Whitney
statistic of the class-1 probability with average ranks for tied scores,
which is what ``roc_auc_score`` computes, and -1 for more classes.
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


def _softmax(x: np.ndarray) -> np.ndarray:
    """Row softmax, as ``scipy.special.softmax(x, axis=1)`` computes it."""
    e = np.exp(x - np.max(x, axis=1, keepdims=True))
    return e / np.sum(e, axis=1, keepdims=True)


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of ``x``, tied values sharing their mean rank."""
    order = np.argsort(x, kind="mergesort")
    xs = x[order]
    starts = np.flatnonzero(np.r_[True, xs[1:] != xs[:-1]])
    ends = np.r_[starts[1:], len(xs)]
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    return ranks


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC AUC of ``scores`` for ``labels == 1`` (the Mann-Whitney
    U over both classes' sizes); raises, as sklearn does, when only one
    class is present."""
    y = np.asarray(labels).reshape(-1)
    classes = np.unique(y)
    if len(classes) != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score is "
                         "not defined in that case.")
    pos = y == classes[1]
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    ranks = _average_ranks(np.asarray(scores, np.float64).reshape(-1))
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def classification_scores(
    outputs: np.ndarray, ids: list, labels: np.ndarray
) -> tuple[float, float, float, dict]:
    """Per-id mean logits → softmax → accuracy / F1 / AUC and the frame
    ``id, label, score_0, …`` (``get_classification_scores``,
    ``2_HistoPath_train.py:150-182``); labels from the last occurrence of
    each id."""
    outputs = np.asarray(outputs)
    n_class = outputs.shape[1]
    uids, mean_scores = _group_mean(outputs, ids)
    probs = _softmax(mean_scores)
    lookup = dict(zip(ids, np.asarray(labels).reshape(-1)))
    label_list = np.array([lookup[i] for i in uids])
    preds = np.argmax(probs, axis=1)

    acc = float(np.mean(label_list == preds))
    if n_class > 2:
        f1 = acc
        auc = -1.0
    else:
        tp = int(np.sum((preds == 1) & (label_list == 1)))
        wrong = int(np.sum(preds != label_list))
        f1 = 2.0 * tp / (2 * tp + wrong) if 2 * tp + wrong else 0.0
        auc = roc_auc(label_list, probs[:, 1])

    frame = {"id": uids, "label": label_list.tolist()}
    frame.update({f"score_{i}": probs[:, i].tolist() for i in range(n_class)})
    return acc, f1, auc, frame


def nllsurv_ci(
    outputs: np.ndarray,
    vital_status: np.ndarray,
    survival_months: np.ndarray,
    ids: list,
    num_classes: int,
) -> tuple[float, dict]:
    """Per-id mean bin logits → risk = -Σ cumprod(1 - sigmoid) → censored
    C-index and the frame ``id, score, survival_months, vital_status``
    (``get_nllsurv_CI``, ``2_HistoPath_train.py:211-280``)."""
    outputs = np.asarray(outputs)[:, :num_classes]
    uids, mean_logits = _group_mean(outputs, ids)
    lookup_m = dict(zip(ids, np.asarray(survival_months).reshape(-1)))
    lookup_v = dict(zip(ids, np.asarray(vital_status).reshape(-1)))
    months = np.array([lookup_m[i] for i in uids])
    status = np.array([lookup_v[i] for i in uids])

    hazards = 1.0 / (1.0 + np.exp(-mean_logits))
    risk = -np.cumprod(1.0 - hazards, axis=-1).sum(axis=-1)

    # sksurv's concordance_index_censored: risks direct, higher = worse
    ci = _concordance_from_risk(months, risk, status.astype(bool))
    frame = {
        "id": uids,
        "score": risk.tolist(),
        "survival_months": months.tolist(),
        "vital_status": status.tolist(),
    }
    return ci, frame
