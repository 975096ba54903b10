"""Survival-analysis statistics over model risk scores.

The port's own copy of ``multimodalbrainsurvival_tpu/ops/survival.py``
(numpy and ``scipy.stats`` on the host, float64, as there): the
Kaplan-Meier product-limit estimator with Greenwood log-minus-log bands
(``:71-159``), the k-sample log-rank test (``:169``), risk groups at a
cutoff (``:221``), the IPCW Brier score, integrated Brier score and
cumulative/dynamic AUC(t) (``:292-427``), the evaluation-time grid
(``:428``) and the Cox proportional-hazards fit by Newton-Raphson with
Wald inference (``:452-701``). They run once per evaluation on hundreds to
thousands of cases; ``cli/evaluate_scores.py`` consumes them.

The one device function is ``bootstrap_concordance``, the C-index with a
percentile bootstrap interval: ``n_boot`` resamples of O(n²) pair counts,
the only heavy work of an evaluation. The resample indices are drawn on
the host exactly as the JAX loop draws them (one ``rng.integers(0, n,
size=n)`` per resample, in order, so the stream is the loop's whatever
numpy's buffering of bounded draws across calls), uploaded once with the
times, scores and events, and each
resample's comparable, concordant and risk-tied pairs (those of
``ops/metrics.py::_concordance_quadratic``) are counted on ``device``:
as quadratic forms of the resamples' case multiplicities with the cases'
pair matrices, float64 matrix products whose integer results are exact,
under a memory budget (``bootstrap_pair_counts``). ``C = (concordant +
0.5 ties) / comparable`` is then taken in float64 on the host from the
integer counts, as the JAX loop takes it, so the point estimate and both
bounds equal the JAX function's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodalbrainsurvival_torch.ops.metrics import concordance_index

#: the risk-tie band of ``ops/metrics.py``'s pair counting
TIED_TOL = 1e-8
#: the bootstrap's bytes for a block of its pair matrices on the device
BOOT_MEMORY_BUDGET = 1 << 30


def _as_arrays(times, events):
    t = np.asarray(times, dtype=np.float64).reshape(-1)
    e = np.asarray(events).reshape(-1).astype(bool)
    if t.shape != e.shape:
        raise ValueError(f"times {t.shape} and events {e.shape} differ")
    if t.size == 0:
        raise ValueError("empty survival data")
    if np.any(~np.isfinite(t)) or np.any(t < 0):
        raise ValueError("survival times must be finite and non-negative")
    return t, e


@dataclasses.dataclass
class KaplanMeier:
    """Product-limit estimate evaluated at the distinct event times.

    ``survival[i]`` is S(time[i]) — the value of the right-continuous step
    function *at and after* ``time[i]`` until the next event time. S(t) = 1
    for t before ``time[0]``.
    """

    time: np.ndarray        # distinct event times, ascending
    survival: np.ndarray    # S(t) at each event time
    at_risk: np.ndarray     # n_i: subjects at risk just before time[i]
    observed: np.ndarray    # d_i: events at time[i]
    ci_lower: np.ndarray    # pointwise lower confidence band
    ci_upper: np.ndarray    # pointwise upper confidence band
    alpha: float            # band level: (1 - alpha) two-sided

    def step_function(self, at: np.ndarray) -> np.ndarray:
        """S evaluated at arbitrary times (right-continuous step lookup)."""
        at = np.asarray(at, dtype=np.float64)
        idx = np.searchsorted(self.time, at, side="right") - 1
        s = np.concatenate([[1.0], self.survival])
        return s[idx + 1]

    def left_limit(self, at: np.ndarray) -> np.ndarray:
        """S(t-): the value just *before* each time (left-continuous lookup).

        Used for IPCW weights 1/G(T-) so a subject's own drop at T does not
        enter its weight (the deaths-before-censorings tie convention)."""
        at = np.asarray(at, dtype=np.float64)
        idx = np.searchsorted(self.time, at, side="left") - 1
        s = np.concatenate([[1.0], self.survival])
        return s[idx + 1]

    @property
    def median_survival(self) -> float:
        """First time S(t) <= 0.5; inf if the curve never reaches it."""
        below = np.flatnonzero(self.survival <= 0.5)
        return float(self.time[below[0]]) if below.size else float("inf")


def kaplan_meier(times, events, alpha: float = 0.05) -> KaplanMeier:
    """Kaplan-Meier estimator with Greenwood log-minus-log confidence bands.

    At each distinct event time t_i with n_i at risk and d_i events:
    S(t_i) = prod_{j<=i} (1 - d_j/n_j). Greenwood:
    Var[log S] = sum d_j / (n_j (n_j - d_j)); the band is computed on the
    log(-log S) scale (exp(-exp(...))), which is the lifelines / R
    ``survival`` default and cannot leave [0, 1].
    """
    from scipy.stats import norm

    t, e = _as_arrays(times, events)
    order = np.argsort(t, kind="stable")
    t, e = t[order], e[order]

    event_times = np.unique(t[e])
    if event_times.size == 0:
        # all censored: flat S(t) = 1 with no event steps
        return KaplanMeier(
            time=np.array([]), survival=np.array([]),
            at_risk=np.array([], np.int64), observed=np.array([], np.int64),
            ci_lower=np.array([]), ci_upper=np.array([]), alpha=alpha,
        )

    # n_i: at risk just before each event time; d_i: events at that time
    n_at_risk = t.size - np.searchsorted(t, event_times, side="left")
    d = np.array([int(np.sum((t == et) & e)) for et in event_times])

    frac = 1.0 - d / n_at_risk
    surv = np.cumprod(frac)

    # Greenwood on the log(-log) scale; degenerate terms (n == d, S == 0 or
    # S == 1) get NaN bands, matching lifelines' behaviour at the curve tail
    with np.errstate(divide="ignore", invalid="ignore"):
        green = np.cumsum(d / (n_at_risk * (n_at_risk - d).astype(np.float64)))
        log_s = np.log(surv)
        se_cloglog = np.sqrt(green) / np.abs(log_s)
        z = norm.ppf(1.0 - alpha / 2.0)
        theta = np.log(-log_s)
        lower = np.exp(-np.exp(theta + z * se_cloglog))
        upper = np.exp(-np.exp(theta - z * se_cloglog))

    return KaplanMeier(
        time=event_times, survival=surv,
        at_risk=n_at_risk.astype(np.int64), observed=d.astype(np.int64),
        ci_lower=lower, ci_upper=upper, alpha=alpha,
    )


@dataclasses.dataclass
class LogrankResult:
    chi2: float
    p_value: float
    df: int
    observed: np.ndarray  # per-group observed event counts
    expected: np.ndarray  # per-group expected event counts under H0


def logrank_test(times, events, groups) -> LogrankResult:
    """k-sample log-rank test.

    At each distinct event time t with n at risk overall, n_g at risk in
    group g, and d events total, group g expects E_g = d * n_g / n events;
    the covariance of the observed counts is the multivariate
    hypergeometric one:
    V_gh = d (n - d) / (n - 1) * (delta_gh n_g / n - n_g n_h / n^2).
    The statistic (O - E)' V^+ (O - E) over the first k-1 groups is
    chi-squared with k-1 degrees of freedom under H0. For k = 2 this is
    the textbook (O_1 - E_1)^2 / V_11 form (verified against
    ``scipy.stats.logrank`` in tests/test_survival.py).
    """
    from scipy.stats import chi2 as chi2_dist

    t, e = _as_arrays(times, events)
    g = np.asarray(groups).reshape(-1)
    if g.shape != t.shape:
        raise ValueError(f"groups {g.shape} and times {t.shape} differ")
    labels, g_idx = np.unique(g, return_inverse=True)
    k = labels.size
    if k < 2:
        raise ValueError("log-rank test needs at least two groups")

    event_times = np.unique(t[e])
    observed = np.zeros(k)
    expected = np.zeros(k)
    cov = np.zeros((k, k))
    for et in event_times:
        at_risk = t >= et
        n = float(at_risk.sum())
        d = float(np.sum((t == et) & e))
        if n <= 0 or d <= 0:
            continue
        n_g = np.array([float(np.sum(at_risk & (g_idx == j))) for j in range(k)])
        d_g = np.array([float(np.sum((t == et) & e & (g_idx == j)))
                        for j in range(k)])
        observed += d_g
        expected += d * n_g / n
        if n > 1:
            hyper = d * (n - d) / (n - 1.0)
            cov += hyper * (np.diag(n_g / n) - np.outer(n_g, n_g) / n**2)

    delta = (observed - expected)[: k - 1]
    v = cov[: k - 1, : k - 1]
    # pinv: a group with no at-risk overlap contributes a singular direction
    chi2 = float(delta @ np.linalg.pinv(v) @ delta)
    p = float(chi2_dist.sf(chi2, df=k - 1))
    return LogrankResult(chi2=chi2, p_value=p, df=k - 1,
                         observed=observed, expected=expected)


def risk_groups(scores, cutoff: float | None = None) -> tuple[np.ndarray, float]:
    """Split scores into low (0) / high (1) risk at ``cutoff``.

    ``cutoff`` defaults to the median of ``scores``; the paper's protocol
    fixes it at the *training* cohort's median score and applies it
    unchanged to validation/test cohorts — pass that value explicitly.
    Scores strictly above the cutoff are high risk, so a median cutoff on
    an odd-length cohort puts the median case in the low-risk group.
    """
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    if cutoff is None:
        cutoff = float(np.median(s))
    return (s > cutoff).astype(np.int64), float(cutoff)


def resample_indices(n: int, n_boot: int, seed: int) -> np.ndarray:
    """(n_boot, n) int64 resample indices, one ``rng.integers(0, n,
    size=n)`` draw per resample in order, the JAX loop's stream."""
    rng = np.random.default_rng(seed)
    idx = np.empty((n_boot, n), np.int64)
    for b in range(n_boot):
        idx[b] = rng.integers(0, n, size=n)
    return idx


def bootstrap_pair_counts(times, risks, events, idx: np.ndarray,
                          device: torch.device | str = "cpu",
                          memory_budget: int = BOOT_MEMORY_BUDGET) -> np.ndarray:
    """(n_boot, 3) int64: each resample's comparable, concordant and
    risk-tied pairs (``|r_i - r_j| <= TIED_TOL``), counted on ``device``.

    Pair (i, j) is comparable when ``t_i < t_j`` and i had the event, or
    ``t_i == t_j``, i had it and j did not; it is concordant when
    ``r_i > r_j`` outside the tie band. A resample holds case i ``m_i``
    times and no case is comparable with itself, so its count of a kind
    of pair is the quadratic form ``m' P m`` of the cases' 0/1 pair
    matrix P: three float64 matrix products over all resamples at once,
    exact (every product and sum is an integer below 2**53). P is built a
    block of columns at a time, its block and the products' under
    ``memory_budget`` bytes."""
    device = torch.device(device)
    t = torch.as_tensor(np.asarray(times, np.float64), device=device)
    r = torch.as_tensor(np.asarray(risks, np.float64), device=device)
    e = torch.as_tensor(np.asarray(events, bool), device=device)
    n_boot, n = idx.shape
    ix = torch.as_tensor(idx, device=device)
    rows = torch.arange(n_boot, device=device)[:, None] * n
    m = torch.zeros(n_boot * n, dtype=torch.float64, device=device)
    m.index_add_(0, (rows + ix).reshape(-1),
                 torch.ones(n_boot * n, dtype=torch.float64, device=device))
    m = m.view(n_boot, n)
    counts = torch.zeros((n_boot, 3), dtype=torch.float64, device=device)
    # a column of P: its float64 copy and a few bool masks; of m @ P: two
    # float64 values a resample
    block = max(1, memory_budget // (16 * n + 16 * n_boot))
    ti, ri, ei = t[:, None], r[:, None], e[:, None]
    for j0 in range(0, n, block):
        tj, rj, ej = t[None, j0:j0 + block], r[None, j0:j0 + block], e[None, j0:j0 + block]
        comparable = ei & ((ti < tj) | (~ej & (ti == tj)))
        tied = (ri - rj).abs() <= TIED_TOL
        pairs = (comparable, comparable & (ri > rj) & ~tied, comparable & tied)
        for k, p in enumerate(pairs):
            counts[:, k] += ((m @ p.double()) * m[:, j0:j0 + block]).sum(dim=1)
    return counts.to(torch.int64).cpu().numpy()


def bootstrap_concordance(
    times,
    scores,
    events,
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
    device: torch.device | str = "cpu",
) -> dict:
    """C-index point estimate + percentile bootstrap confidence interval.

    Resamples cases with replacement; degenerate resamples with no
    comparable pair (all-censored draws) are skipped. ``scores`` are risk
    scores (higher = shorter expected survival), matching the savescore
    frames; the point estimate is :func:`ops.metrics.concordance_index`
    of ``-score``, as in the reference's evaluation
    (``2_HistoPath_train.py:207``). The resamples' pairs are counted on
    ``device`` (``bootstrap_pair_counts``).
    """
    t, e = _as_arrays(times, events)
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    if s.shape != t.shape:
        raise ValueError(f"scores {s.shape} and times {t.shape} differ")

    point = concordance_index(t, -s, e)
    counts = bootstrap_pair_counts(t, s, e, resample_indices(t.size, n_boot, seed),
                                   device)
    comparable, concordant, tied = counts[counts[:, 0] > 0].T
    # the JAX loop's arithmetic: int64 counts, float64 sums and quotient
    draws = (concordant + 0.5 * tied) / comparable
    lo, hi = (
        (float(np.quantile(draws, alpha / 2)),
         float(np.quantile(draws, 1 - alpha / 2)))
        if draws.size
        else (float("nan"), float("nan"))
    )
    return {
        "c_index": float(point),
        "ci_lower": lo,
        "ci_upper": hi,
        "alpha": float(alpha),
        "n_boot": int(draws.size),
    }


# ---------------------------------------------------------------------------
# Time-dependent prediction accuracy (inverse-probability-of-censoring
# weighted): Brier score / integrated Brier score (Graf et al. 1999) and
# cumulative/dynamic AUC(t) (Uno et al. 2007). The reference evaluates only
# the C-index point estimate (``2_HistoPath_train.py:184-209``); these are
# the calibration- and time-resolved-discrimination halves of the standard
# survival-model report, computed over the same savescore frames.
# ---------------------------------------------------------------------------


def _censoring_km(times, events) -> KaplanMeier:
    """Kaplan-Meier estimate G of the CENSORING distribution (labels
    flipped: a censoring is the 'event'). The at-risk rule ``t >= et``
    keeps subjects with an event at t in the risk set for a censoring at
    the same t — the deaths-before-censorings tie convention IPCW needs."""
    t, e = _as_arrays(times, events)
    return kaplan_meier(t, ~e)


def _check_eval_times(eval_times, t, G: KaplanMeier) -> np.ndarray:
    taus = np.asarray(eval_times, dtype=np.float64).reshape(-1)
    if taus.size == 0:
        raise ValueError("eval_times is empty")
    if np.any(~np.isfinite(taus)) or np.any(taus < 0):
        raise ValueError("eval_times must be finite and non-negative")
    if np.any(np.diff(taus) <= 0):
        raise ValueError("eval_times must be strictly increasing")
    if taus[-1] >= t.max():
        raise ValueError(
            f"eval time {taus[-1]:g} is beyond follow-up (max observed "
            f"time {t.max():g}): no at-risk subjects remain"
        )
    if np.any(G.step_function(taus) <= 0.0):
        raise ValueError(
            "censoring survival G(t) reaches 0 before the last eval time; "
            "IPCW weights are undefined there"
        )
    return taus


def brier_score(times, events, surv_probs, eval_times,
                censor_times=None, censor_events=None) -> np.ndarray:
    """IPCW Brier score BS(t) at each eval time (Graf et al. 1999).

    ``surv_probs[i, j]`` is the model's predicted S(eval_times[j] | x_i).
    At horizon t, a subject with an observed event by t contributes
    S_hat(t)^2 / G(T_i-), a subject still at risk contributes
    (1 - S_hat(t))^2 / G(t), and a subject censored by t contributes 0 —
    the censoring Kaplan-Meier G reweights the observable outcomes so the
    expectation recovers the uncensored Brier score. With no censoring this
    reduces exactly to mean((1{T_i > t} - S_hat)^2) (pinned in
    tests/test_survival.py). ``censor_times``/``censor_events`` optionally
    estimate G from a different cohort (e.g. the training split); default
    is the evaluated data itself.
    """
    t, e = _as_arrays(times, events)
    S = np.asarray(surv_probs, dtype=np.float64)
    if S.ndim == 1:
        S = S[:, None]
    G = _censoring_km(censor_times if censor_times is not None else t,
                      censor_events if censor_events is not None else e)
    taus = _check_eval_times(eval_times, t, G)
    if S.shape != (t.size, taus.size):
        raise ValueError(
            f"surv_probs {S.shape} != (n={t.size}, k={taus.size})"
        )
    if np.any(S < -1e-9) or np.any(S > 1.0 + 1e-9):
        raise ValueError("surv_probs must be probabilities in [0, 1]")

    g_event = G.left_limit(t)          # G(T_i-), per subject
    g_at = G.step_function(taus)       # G(t), per eval time
    had_event = (t[:, None] <= taus[None, :]) & e[:, None]
    at_risk = t[:, None] > taus[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        contrib = np.where(
            had_event, S**2 / g_event[:, None],
            np.where(at_risk, (1.0 - S) ** 2 / g_at[None, :], 0.0),
        )
    if not np.all(np.isfinite(contrib)):
        raise ValueError("IPCW weight degenerate: G(T-) = 0 for an event")
    return contrib.mean(axis=0)


def integrated_brier_score(times, events, surv_probs, eval_times,
                           censor_times=None, censor_events=None) -> float:
    """IBS: the trapezoidal mean of BS(t) over [eval_times[0], eval_times[-1]],
    normalized by the span (Graf et al. 1999 eq. 19). Needs >= 2 times."""
    taus = np.asarray(eval_times, dtype=np.float64).reshape(-1)
    if taus.size < 2:
        raise ValueError("integrated_brier_score needs >= 2 eval times")
    bs = brier_score(times, events, surv_probs, taus,
                     censor_times=censor_times, censor_events=censor_events)
    return float(np.trapezoid(bs, taus) / (taus[-1] - taus[0]))


def cumulative_dynamic_auc(times, events, scores, eval_times,
                           censor_times=None, censor_events=None,
                           ) -> tuple[np.ndarray, float]:
    """Cumulative/dynamic time-dependent AUC(t) with IPCW (Uno et al. 2007).

    At horizon t, *cases* are subjects with an observed event by t
    (weighted 1/G(T_i-)) and *controls* are subjects still at risk
    (T_j > t); AUC(t) is the weighted probability that a case outranks a
    control on the risk ``scores`` (ties count 1/2). With no censoring it
    equals ``sklearn.metrics.roc_auc_score`` with labels 1{T_i <= t}
    (pinned in tests/test_survival.py). Returns ``(auc_at_t, mean_auc)``
    where ``mean_auc`` integrates AUC(t) against the Kaplan-Meier
    decrements of the evaluated cohort's survival function, normalized by
    their total mass — Uno's restricted-mean summary (the sksurv
    ``cumulative_dynamic_auc`` convention). A horizon with no cases or no
    controls yields NaN and is excluded (mass-renormalized) from the mean.
    """
    t, e = _as_arrays(times, events)
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    if s.shape != t.shape:
        raise ValueError(f"scores {s.shape} and times {t.shape} differ")
    G = _censoring_km(censor_times if censor_times is not None else t,
                      censor_events if censor_events is not None else e)
    taus = _check_eval_times(eval_times, t, G)

    g_event = G.left_limit(t)
    auc = np.full(taus.size, np.nan)
    for j, tau in enumerate(taus):
        case = (t <= tau) & e
        ctrl = t > tau
        if not case.any() or not ctrl.any():
            continue
        w = 1.0 / g_event[case]
        if not np.all(np.isfinite(w)):
            raise ValueError("IPCW weight degenerate: G(T-) = 0 for an event")
        sc, sk = s[case], s[ctrl]
        wins = (sc[:, None] > sk[None, :]) + 0.5 * (sc[:, None] == sk[None, :])
        auc[j] = float((w @ wins).sum() / (w.sum() * sk.size))

    km = kaplan_meier(t, e)
    s_at = km.step_function(taus)
    mass = -np.diff(np.concatenate([[1.0], s_at]))
    ok = np.isfinite(auc)
    mean_auc = (
        float(np.sum(auc[ok] * mass[ok]) / np.sum(mass[ok]))
        if ok.any() and np.sum(mass[ok]) > 0
        else float("nan")
    )
    return auc, mean_auc


def default_eval_times(times, events, n_times: int = 9) -> np.ndarray:
    """Evaluation-time grid for the time-dependent metrics: percentiles
    10..90 of the distinct observed EVENT times, deduplicated and kept
    strictly inside the follow-up window with G(t) > 0 — i.e. every
    returned horizon has at least one case, at least one possible control,
    and finite IPCW weights. May return fewer than ``n_times`` (or empty
    on degenerate cohorts)."""
    t, e = _as_arrays(times, events)
    ets = np.unique(t[e])
    if ets.size == 0:
        return np.array([])
    taus = np.unique(np.percentile(ets, np.linspace(10, 90, n_times)))
    taus = taus[taus < t.max()]
    if taus.size:
        G = _censoring_km(t, e)
        taus = taus[G.step_function(taus) > 0.0]
    return taus


# ---------------------------------------------------------------------------
# Cox proportional-hazards regression
# ---------------------------------------------------------------------------


def _cox_ll_grad_hess(beta, X, t, e, ties: str):
    """Partial log-likelihood, score vector, and observed information.

    ``X`` is (n, p) sorted ascending by ``t``. Uses reverse cumulative sums
    for the risk-set moments S0 = sum w, S1 = sum x w, S2 = sum x x' w over
    R(t) = {j : t_j >= t}; ties by Breslow (one shared denominator per tied
    set) or Efron (the tied set leaves the denominator in d fractional
    steps). Information is returned positive-definite (−Hessian).
    """
    n, p = X.shape
    xb = X @ beta
    # exp-offset keeps w finite for large |X beta|; log S0 adds it back
    m = float(np.max(xb))
    w = np.exp(xb - m)
    xw = X * w[:, None]
    xxw = X[:, :, None] * X[:, None, :] * w[:, None, None]
    s0 = np.cumsum(w[::-1])[::-1]
    s1 = np.cumsum(xw[::-1], axis=0)[::-1]
    s2 = np.cumsum(xxw[::-1], axis=0)[::-1]

    ll = 0.0
    score = np.zeros(p)
    info = np.zeros((p, p))
    for et in np.unique(t[e]):
        r = int(np.searchsorted(t, et, side="left"))
        dsel = (t == et) & e
        d = int(dsel.sum())
        ll += float(xb[dsel].sum()) - d * m
        if ties == "breslow":
            ll -= d * np.log(s0[r])
            mu = s1[r] / s0[r]
            score += X[dsel].sum(axis=0) - d * mu
            info += d * (s2[r] / s0[r] - np.outer(mu, mu))
        elif ties == "efron":
            wd = float(w[dsel].sum())
            xwd = xw[dsel].sum(axis=0)
            xxwd = xxw[dsel].sum(axis=0)
            score += X[dsel].sum(axis=0)
            for l in range(d):
                phi = l / d
                s0e = s0[r] - phi * wd
                s1e = s1[r] - phi * xwd
                s2e = s2[r] - phi * xxwd
                ll -= np.log(s0e)
                mu = s1e / s0e
                score -= mu
                info += s2e / s0e - np.outer(mu, mu)
        else:
            raise ValueError(f"unknown ties method {ties!r}")
    return ll, score, info


@dataclasses.dataclass
class CoxPHResult:
    """Fitted Cox PH model with Wald inference.

    ``coef[i]`` is the log hazard ratio for ``names[i]``; ``hr`` / the CI
    are on the hazard-ratio scale. ``baseline_time`` /
    ``baseline_cumhaz`` give the Breslow baseline cumulative hazard at the
    distinct event times, so S(t | x) = exp(-H0(t) * exp(x @ coef)).
    """

    names: list
    coef: np.ndarray
    se: np.ndarray
    z: np.ndarray
    p_value: np.ndarray
    hr: np.ndarray
    hr_ci_lower: np.ndarray
    hr_ci_upper: np.ndarray
    alpha: float
    ties: str
    log_likelihood: float
    ll_null: float
    lr_chi2: float
    lr_p: float
    score_chi2: float
    score_p: float
    n: int
    n_events: int
    n_iter: int
    converged: bool
    baseline_time: np.ndarray
    baseline_cumhaz: np.ndarray

    def summary_rows(self) -> list:
        """Per-covariate dicts, ready for a DataFrame / JSON report."""
        return [
            {
                "covariate": self.names[i],
                "coef": float(self.coef[i]),
                "se": float(self.se[i]),
                "z": float(self.z[i]),
                "p": float(self.p_value[i]),
                "hr": float(self.hr[i]),
                "hr_ci_lower": float(self.hr_ci_lower[i]),
                "hr_ci_upper": float(self.hr_ci_upper[i]),
            }
            for i in range(len(self.names))
        ]

    def predict_survival(self, x_row, at: np.ndarray) -> np.ndarray:
        """S(t | x) from the Breslow baseline (right-continuous lookup).

        ``x_row`` of shape (p,) returns S at each of the ``at`` times,
        shape (k,); a matrix of shape (n, p) returns the (n, k) survival
        matrix (the shape ``brier_score`` consumes)."""
        at = np.asarray(at, dtype=np.float64)
        idx = np.searchsorted(self.baseline_time, at, side="right") - 1
        h0 = np.concatenate([[0.0], self.baseline_cumhaz])[idx + 1]
        x = np.asarray(x_row, np.float64)
        if x.ndim == 2:
            return np.exp(-np.outer(np.exp(x @ self.coef), h0))
        return np.exp(-h0 * float(np.exp(x @ self.coef)))


def cox_ph(
    times,
    events,
    covariates,
    names=None,
    ties: str = "breslow",
    alpha: float = 0.05,
    max_iter: int = 100,
    tol: float = 1e-9,
) -> CoxPHResult:
    """Multivariable Cox proportional-hazards fit with Wald inference.

    Newton-Raphson on the partial log-likelihood (Breslow or Efron ties)
    with step-halving; converges when the score's max-norm drops below
    ``tol``. Covariates are internally centered (the partial likelihood is
    exactly invariant to location shifts, so the reported ``coef`` is
    unchanged — only the Newton conditioning improves).

    The reference computes only the C-index (``2_HistoPath_train.py:184-209``)
    and defers regression analyses to external R tooling; this is the native
    replacement. Consistency oracles live in tests/test_survival.py:
    score test == log-rank on untied binary groups, MLE == an independent
    scipy.optimize fit of a loop-written likelihood, SE == the
    finite-difference observed information, and coef == ``ops.coxnet`` at
    vanishing penalty.
    """
    from scipy.stats import chi2 as chi2_dist
    from scipy.stats import norm

    t, e = _as_arrays(times, events)
    X = np.asarray(covariates, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    if X.shape[0] != t.size:
        raise ValueError(f"covariates {X.shape} vs times {t.shape}")
    n, p = X.shape
    if names is None:
        names = [f"x{i}" for i in range(p)]
    names = list(names)
    if len(names) != p:
        raise ValueError(f"{len(names)} names for {p} covariates")
    if not e.any():
        raise ValueError("Cox PH needs at least one event")
    const = np.ptp(X, axis=0) == 0
    if const.any():
        bad = [names[i] for i in np.flatnonzero(const)]
        raise ValueError(f"constant covariate(s) {bad} are not identifiable")

    order = np.argsort(t, kind="stable")
    t, e, X = t[order], e[order], X[order]
    center = X.mean(axis=0)
    Xc = X - center

    beta = np.zeros(p)
    ll_null, score0, info0 = _cox_ll_grad_hess(beta, Xc, t, e, ties)
    score_chi2 = float(score0 @ np.linalg.solve(info0, score0))

    ll = ll_null
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        _, score, info = _cox_ll_grad_hess(beta, Xc, t, e, ties)
        if float(np.max(np.abs(score))) < tol:
            break
        step = np.linalg.solve(info, score)
        # step-halving: the partial likelihood is concave, but a full Newton
        # step from a poor iterate can overshoot on near-separated data
        scale = 1.0
        for _ in range(30):
            ll_new, _, _ = _cox_ll_grad_hess(beta + scale * step, Xc, t, e, ties)
            if ll_new > ll - 1e-12:
                break
            scale *= 0.5
        beta = beta + scale * step
        ll = ll_new

    ll, score, info = _cox_ll_grad_hess(beta, Xc, t, e, ties)
    converged = bool(float(np.max(np.abs(score))) < tol)
    if not converged:
        # near-complete separation / monotone likelihood: coefs and SEs are
        # not trustworthy; flag instead of reporting as a clean fit
        import warnings

        warnings.warn(
            f"cox_ph did not converge in {max_iter} iterations "
            f"(score max-norm {float(np.max(np.abs(score))):.3g} >= tol "
            f"{tol:g}); estimates may be unstable",
            RuntimeWarning,
            stacklevel=2,
        )
    cov = np.linalg.inv(info)
    se = np.sqrt(np.diag(cov))
    z = beta / se
    pvals = 2.0 * norm.sf(np.abs(z))
    zcrit = norm.ppf(1.0 - alpha / 2.0)
    lr_chi2 = float(2.0 * (ll - ll_null))

    # Breslow baseline cumulative hazard at beta-hat: H0(t) = sum over event
    # times <= t of d_t / S0(t). Computed on the UNcentered covariates so
    # predict_survival takes raw rows.
    xb = X @ beta
    m = float(np.max(xb))
    w = np.exp(xb - m)
    s0 = np.cumsum(w[::-1])[::-1]
    ets = np.unique(t[e])
    increments = np.empty(ets.size)
    for i, et in enumerate(ets):
        r = int(np.searchsorted(t, et, side="left"))
        d = int(np.sum((t == et) & e))
        increments[i] = d / (s0[r] * np.exp(m))

    return CoxPHResult(
        names=names,
        coef=beta,
        se=se,
        z=z,
        p_value=pvals,
        hr=np.exp(beta),
        hr_ci_lower=np.exp(beta - zcrit * se),
        hr_ci_upper=np.exp(beta + zcrit * se),
        alpha=float(alpha),
        ties=ties,
        log_likelihood=float(ll),
        ll_null=float(ll_null),
        lr_chi2=lr_chi2,
        lr_p=float(chi2_dist.sf(lr_chi2, df=p)),
        score_chi2=score_chi2,
        score_p=float(chi2_dist.sf(score_chi2, df=p)),
        n=int(n),
        n_events=int(e.sum()),
        n_iter=n_iter,
        converged=converged,
        baseline_time=ets,
        baseline_cumhaz=np.cumsum(increments),
    )
