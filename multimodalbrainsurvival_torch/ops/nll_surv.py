"""Discrete-time survival negative log-likelihood (Zadeh & Schmid 2020).

The port of ``multimodalbrainsurvival_tpu/ops/nll_surv.py:24-76``, the loss
the reference exposes as ``NLLSurvLoss`` (``1_HistoPathology/models.py:
121-232``):

- ``hazards = sigmoid(h)``; ``S = cumprod(1 - hazards)`` along the bin axis;
- ``S`` is left-padded with 1 so ``S_padded[y]`` is the survival entering
  bin ``y``;
- uncensored rows (``c == 0``) pay ``-(log S_padded[y] + log hazards[y])``,
  censored rows pay ``-(1 - alpha) * log S_padded[y + 1]``;
- every gathered probability is clamped at ``eps`` before the log;
- ``mask`` marks the real rows of a padded batch: pads contribute 0 and
  are left out of the mean.

It computes in float32 whatever the head's dtype.
"""

from __future__ import annotations

import torch


def nll_surv_loss(
    h: torch.Tensor,
    y: torch.Tensor,
    c: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    alpha: float = 0.0,
    eps: float = 1e-7,
    reduction: str = "mean",
) -> torch.Tensor:
    """Negative log-likelihood for discrete time-to-event bins.

    Args:
      h: ``(B, K)`` raw logits; the per-bin hazard is ``sigmoid(h)``.
      y: ``(B,)`` integer bin index in ``[0, K)``.
      c: ``(B,)`` censoring indicator (1 = censored / alive, 0 = death).
      mask: optional ``(B,)`` validity mask (True = real row).
      alpha: down-weights the censored term by ``(1 - alpha)``.
      eps: clamp floor before the logs.
      reduction: ``"mean"`` | ``"sum"`` | ``"none"``.
    """
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"Bad reduction: {reduction!r}")
    h = h.float()
    B = h.shape[0]
    y = y.reshape(B, 1).long()
    c = c.reshape(B, 1).float()

    hazards = torch.sigmoid(h)
    S = torch.cumprod(1.0 - hazards, dim=1)
    S_padded = torch.cat([torch.ones((B, 1), dtype=S.dtype, device=S.device), S], dim=1)

    s_prev = torch.gather(S_padded, 1, y).clamp(min=eps)
    h_this = torch.gather(hazards, 1, y).clamp(min=eps)
    s_this = torch.gather(S_padded, 1, y + 1).clamp(min=eps)

    uncensored = -(1.0 - c) * (torch.log(s_prev) + torch.log(h_this))
    censored = -c * torch.log(s_this)
    loss = ((1.0 - alpha) * censored + uncensored).reshape(B)

    if mask is not None:
        m = mask.reshape(B).float()
        loss = loss * m
        n = torch.clamp(m.sum(), min=1.0)
    else:
        n = torch.tensor(float(B), device=loss.device)

    if reduction == "mean":
        return loss.sum() / n
    if reduction == "sum":
        return loss.sum()
    return loss
