"""Cox proportional-hazards partial-likelihood loss (forward).

Counterpart of ``multimodalbrainsurvival_tpu/ops/cox.py:51-111``: the
reference's batch-local Cox partial likelihood
(``1_HistoPathology/models.py:90-118``) under ``reference_parity=True`` —
max-subtraction, ``log(cumsum(exp(.)) + 1e-5)`` and a mean over every real
row — and the corrected variant (exact ``logcumsumexp``, normalized by the
number of events) under ``reference_parity=False``.

Padded rows (``mask`` False) get sort key ``+inf`` on ``-time``, so a stable
ascending sort places them last and they never enter a real row's risk set.

Under data parallelism (``group``: the mesh's ``dp`` group) the risk set is
the global batch's, as the JAX loss's is under a ``dp`` mesh
(``ops/cox.py:27-32`` there): ``(score, time, event, mask)`` are
all-gathered over the group in rank order, the gather carrying the score's
gradient back to the local rows, and every rank computes the same global
loss.
"""

from __future__ import annotations

import torch

from multimodalbrainsurvival_torch.parallel.mesh import gather


def cox_partial_likelihood_loss(
    scores: torch.Tensor,
    times: torch.Tensor,
    events: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    reference_parity: bool = True,
    eps: float = 1e-5,
    group=None,
) -> torch.Tensor:
    """Negative Cox partial log-likelihood of a batch of risk scores.

    ``scores``, ``times``, ``events`` and the optional validity ``mask`` are
    ``(B,)`` (a rank's rows of the global batch with a ``group``); returns
    a float32 scalar.
    """
    if group is not None:
        scores, times, events = (gather(t.reshape(-1), group) for t in (scores, times, events))
        mask = None if mask is None else gather(mask.reshape(-1), group)
    scores = scores.reshape(-1).float()
    times = times.reshape(-1).float()
    events = events.reshape(-1).float()
    if mask is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    else:
        valid = mask.reshape(-1).bool()

    inf = torch.tensor(float("inf"), device=scores.device)
    # stable: tied times keep their batch order, as in the reference
    order = torch.sort(torch.where(valid, -times, inf), stable=True).indices
    s, e, v = scores[order], events[order], valid[order]

    s_max = torch.where(v, s, -inf).max()
    shifted = torch.where(v, s - s_max, -inf)

    if reference_parity:
        exp_s = torch.where(v, torch.exp(shifted), 0.0)
        log_risk = torch.log(torch.cumsum(exp_s, 0) + eps)
        # where, not a product with v: a pad's -inf times 0 would be NaN
        ll = torch.where(v, (shifted - log_risk) * e, 0.0)
        denom = torch.clamp(v.float().sum(), min=1.0)
        return -ll.sum() / denom
    log_risk = torch.logcumsumexp(shifted, 0)
    ll = torch.where(v & (e > 0), shifted - log_risk, 0.0)
    n_events = torch.where(v, e, 0.0).sum()
    return -ll.sum() / torch.clamp(n_events, min=1.0)
