"""Cross-validated Cox elastic net, the late-fusion model, on one device.

The port's own copy of ``multimodalbrainsurvival_tpu/ops/coxnet.py:1-208``
(R's ``cv.glmnet(x, Surv(t, d), family="cox")``, reference
``4_LateFusion/2_LateFusion.R:27-48``), with the same semantics:

- the Breslow negative log partial likelihood with the full tied risk set
  (each position reads the running log-sum-exp at the last index of its
  tie group), divided by the event count;
- the penalty ``λ (α‖β‖₁ + (1-α)/2 ‖β‖₂²)``, α = 1 (the lasso) by default;
- FISTA with the fixed step ``1/L``, ``L = ‖X‖₂² / n_events + 1e-6``, and
  ``max_iter`` iterations with no early exit, warm-started along a
  geometric λ path from λ_max (the null gradient on the standardized X);
- columns standardized with their mean and population std (zero-sd
  columns by 1), coefficients scaled back by ``1/sd``;
- event-stratified folds from ``np.random.default_rng(seed)`` in the JAX
  order, ``n_folds = min(n_folds, max(2, n // 3))``, a fold with no events
  on either side NaN, and when every fold is, the largest λ with a warning;
- float32 arithmetic; ``CoxnetResult.predict`` in float64.

On the device the folds and the full fit are one batch of problems: the
rows are sorted once by descending time (stable), and each problem masks
the rows outside its training fold, which then add 0 to every risk-set
sum, so each problem's tie groups and sums are its own. Each problem has
its own ``L``. The gradient is the NPLL's analytic one, on the batch. On
a card one λ's ``max_iter`` iterations are captured once as a CUDA graph
and replayed for every λ with the warm start copied in; the CPU runs the
same iterations eagerly.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CoxnetResult:
    beta: np.ndarray          # coefficients at lambda.min (original scale)
    intercept_shift: float    # <beta, mean> removed by standardization
    lambdas: np.ndarray
    cv_mean: np.ndarray
    lambda_min: float
    betas_path: np.ndarray    # (n_lambda, p), original scale
    # how the solve ran: problems, CUDA graph replays (0 on the CPU),
    # iterations and seconds
    stats: dict | None = None

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Linear risk score (glmnet ``predict(type='link')`` without the
        constant, which does not change a Cox ranking)."""
        return np.asarray(X, np.float64) @ self.beta


class CoxProblems:
    """``P`` Cox problems over one design, each on its own rows.

    ``X`` (n, p) float32, ``times`` and ``events`` (n,), ``masks`` (P, n)
    bool: row i is in problem j's data where ``masks[j, i]``.
    """

    def __init__(self, X: np.ndarray, times: np.ndarray, events: np.ndarray,
                 masks: np.ndarray, device: torch.device):
        order = np.argsort(-times, kind="stable")
        neg_t = -times[order]
        n = len(order)
        # first and last index of each position's tie group
        first = np.searchsorted(neg_t, neg_t, side="left")
        last = np.searchsorted(neg_t, neg_t, side="right") - 1
        m = np.asarray(masks, bool)[:, order]
        d = events[order][None, :] * m
        n_ev = np.maximum(d.sum(1, dtype=np.float32), np.float32(1.0))

        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

        self.device = device
        self.X = put(X[order])                       # (n, p)
        self.XT = self.X.T.contiguous()              # (p, n)
        self.logmask = put(np.where(m, 0.0, -np.inf).astype(np.float32))
        self.events = put(d.astype(np.float32))      # (P, n), masked
        self.n_events = put(n_ev)                    # (P,)
        d_scaled = (d / n_ev[:, None]).astype(np.float32)
        self.neg_d_scaled = put(-d_scaled)
        # the reverse running sums read the flipped order: risk sets at
        # last[::-1], tail sums at n - 1 - first
        self.d_scaled_flip = put(d_scaled[:, ::-1])
        self.last = put(last, torch.long)
        self.last_flip = put(last[::-1], torch.long)
        self.first_rev = put(n - 1 - first, torch.long)
        self.masks = put(m.astype(np.float32))

    @property
    def n_problems(self) -> int:
        return self.logmask.shape[0]

    def lipschitz_steps(self) -> torch.Tensor:
        """``1 / (‖X_j‖₂² / n_events_j + 1e-6)`` per problem, (P, 1)."""
        norms = torch.linalg.matrix_norm(self.masks[:, :, None] * self.X, ord=2)
        return (1.0 / (norms ** 2 / self.n_events + 1e-6))[:, None]

    def npll(self, beta: torch.Tensor) -> torch.Tensor:
        """Each problem's Breslow NPLL at its own ``beta`` (..., P, p) →
        (..., P)."""
        eta = beta @ self.XT
        em = eta + self.logmask
        shift = em.amax(-1, keepdim=True)
        scan = torch.log(torch.cumsum(torch.exp(em - shift), -1)) + shift
        ll = torch.where(self.events > 0, (eta - scan[..., self.last]) * self.events, 0.0)
        return -ll.sum(-1) / self.n_events

    def grad(self, beta: torch.Tensor) -> torch.Tensor:
        """The NPLL's gradient at each problem's ``beta`` (P, p).

        ``∂/∂η_m = (e_m Σ_{k ≥ first(m)} d_k / R_k - d_m) / D`` with
        ``e = exp(η - s)`` over the problem's rows, ``R`` the running sum of
        ``e`` read at each tie group's last index, ``D`` the event count."""
        em = torch.mm(beta, self.XT).add_(self.logmask)
        e = torch.exp(em - em.amax(1, keepdim=True))
        risk = torch.cumsum(e, 1).index_select(1, self.last_flip)
        # a row outside the problem before any of its rows has R = 0, d = 0
        w = self.d_scaled_flip / risk.clamp_min_(torch.finfo(torch.float32).tiny)
        tail = torch.cumsum(w, 1).index_select(1, self.first_rev)
        return torch.mm(torch.addcmul(self.neg_d_scaled, e, tail), self.X)


def _momentum(max_iter: int) -> list[float]:
    """FISTA's ``(t - 1) / t_next`` of each iteration, in float32 as the
    JAX loop computes it (``t`` restarts at 1 for every λ)."""
    t, out = np.float32(1.0), []
    for _ in range(max_iter):
        t_new = (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t)) \
            / np.float32(2.0)
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


class FistaSolver:
    """FISTA over a batch of problems with static buffers: ``run(lam)``
    does ``max_iter`` iterations from the warm start in ``beta``."""

    def __init__(self, problems: CoxProblems, alpha: float, max_iter: int):
        dev = problems.device
        p = problems.X.shape[1]
        self.problems = problems
        self.alpha = np.float32(alpha)
        self.max_iter = max_iter
        self.coefs = _momentum(max_iter)
        self.neg_step = -problems.lipschitz_steps()
        self.lam = torch.zeros((), device=dev)
        self.bufs = [torch.zeros(problems.n_problems, p, device=dev) for _ in range(2)]
        self.z = torch.zeros_like(self.bufs[0])
        self.graph = None
        self.replays = 0
        if dev.type == "cuda":
            self._capture()

    @property
    def beta(self) -> torch.Tensor:
        return self.bufs[0]

    def _iterations(self) -> None:
        pr, z = self.problems, self.z
        neg_thr = self.neg_step * self.lam * self.alpha  # -(step·λ·α), (P, 1)
        thr = -neg_thr
        ridge = self.lam * (np.float32(1.0) - self.alpha)
        for i, coef in enumerate(self.coefs):
            beta, beta_new = self.bufs[i % 2], self.bufs[(i + 1) % 2]
            g = pr.grad(z)
            if self.alpha != 1.0:
                g.add_(ridge * z)
            z.addcmul_(g, self.neg_step)                     # z - step·g
            # soft threshold: z - clamp(z, -thr, thr)
            torch.sub(z, torch.clamp(z, min=neg_thr, max=thr), out=beta_new)
            torch.add(beta_new, beta_new - beta, alpha=coef, out=z)
        if self.max_iter % 2:
            self.bufs[0].copy_(self.bufs[1])

    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up the ops before the capture
            self._iterations()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._iterations()

    def run(self, lam: float) -> torch.Tensor:
        self.lam.fill_(float(lam))
        self.z.copy_(self.beta)
        if self.graph is None:
            self._iterations()
        else:
            self.graph.replay()
            self.replays += 1
        return self.beta


def solve_path(fista: FistaSolver, lambdas: np.ndarray) -> np.ndarray:
    """Warm-started solves along ``lambdas``: (n_lambda, P, p) float32."""
    fista.beta.zero_()
    out = torch.stack([fista.run(lam).clone() for lam in lambdas])
    return out.cpu().numpy()


def _lambda_path(problems: CoxProblems, alpha: float, n_lambda: int,
                 lambda_min_ratio: float) -> np.ndarray:
    """Geometric from λ_max, the largest null gradient of the full fit (its
    last problem), as JAX ``coxnet.py:107-117`` computes it."""
    zero = torch.zeros(problems.n_problems, problems.X.shape[1], device=problems.device)
    g0 = problems.grad(zero)[-1].cpu().numpy()
    lam_max = np.max(np.abs(g0)) / max(alpha, 1e-3)
    lam_max = max(lam_max, 1e-4)
    return np.geomspace(lam_max, lam_max * lambda_min_ratio, n_lambda)


def fit_coxnet(
    X: np.ndarray,
    times: np.ndarray,
    events: np.ndarray,
    *,
    alpha: float = 1.0,
    n_lambda: int = 50,
    lambda_min_ratio: float = 1e-3,
    n_folds: int = 10,
    max_iter: int = 500,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> CoxnetResult:
    """``cv.glmnet(family='cox')``: the full path and k-fold CV, solved on
    ``device`` (the module docstring)."""
    device = torch.device(device)
    X = np.asarray(X, np.float32)
    times = np.asarray(times, np.float32).reshape(-1)
    events = np.asarray(events, np.float32).reshape(-1)
    n, p = X.shape

    mu, sd = X.mean(0), X.std(0)
    sd = np.where(sd > 0, sd, 1.0)
    Xs = (X - mu) / sd

    n_folds = min(n_folds, max(2, n // 3))
    rng = np.random.default_rng(seed)
    # event-stratified: events and censored rows are dealt out apart
    fold = np.empty(n, np.int64)
    for m in (events > 0, events <= 0):
        idx = np.flatnonzero(m)
        fold[idx[rng.permutation(len(idx))]] = np.arange(len(idx)) % n_folds
    live = [f for f in range(n_folds)
            if events[fold == f].sum() > 0 and events[fold != f].sum() > 0]

    t0 = time.perf_counter()
    # problems: the live folds' training rows, then the full fit
    train_masks = np.stack([fold != f for f in live] + [np.ones(n, bool)])
    problems = CoxProblems(Xs, times, events, train_masks, device)
    lambdas = _lambda_path(problems, alpha, n_lambda, lambda_min_ratio)
    fista = FistaSolver(problems, alpha, max_iter)
    betas = solve_path(fista, lambdas)                  # (L, P, p)

    cv_dev = np.full((n_folds, len(lambdas)), np.nan)
    if live:
        held_out = CoxProblems(Xs, times, events,
                               np.stack([fold == f for f in live]), device)
        dev = held_out.npll(torch.as_tensor(betas[:, :-1], device=device))
        cv_dev[live] = dev.cpu().numpy().T
    seconds = time.perf_counter() - t0
    with np.errstate(invalid="ignore"):
        cv_mean = np.nanmean(cv_dev, axis=0)
    if np.all(np.isnan(cv_mean)):
        # every fold was event-degenerate: CV cannot choose a λ, so the fit
        # takes the most regularized end of the path, as the JAX one does
        warnings.warn(
            "coxnet CV degenerate: no fold had events on both sides; "
            "falling back to the largest lambda (maximal shrinkage)",
            stacklevel=2,
        )
        best = 0
    else:
        best = int(np.nanargmin(cv_mean))

    betas_orig = betas[:, -1] / sd
    beta = betas_orig[best]
    return CoxnetResult(
        beta=beta.astype(np.float64),
        intercept_shift=float(beta @ mu),
        lambdas=lambdas,
        cv_mean=cv_mean,
        lambda_min=float(lambdas[best]),
        betas_path=betas_orig,
        stats={"device": str(device), "problems": problems.n_problems,
               "graph_replays": fista.replays, "iterations": len(lambdas) * max_iter,
               "seconds": seconds},
    )
