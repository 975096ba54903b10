"""Optimizers: torch Adam parameter groups, relative LR schedules, clipping.

Counterpart of ``multimodalbrainsurvival_tpu/train/optim.py:31-179``. The
JAX package imitates ``torch.optim.Adam(params, lr, weight_decay)`` with
optax (``torch_adam``: ``wd·p`` added to the gradient before the moments,
coupled L2, not AdamW); the port uses it as it is, one parameter group per
``(name, prefix, lr)``. Parameters no group matches are frozen
(``requires_grad=False``), as ``optax.set_to_zero`` freezes them there.

``mil_freeze_ladder`` is the reference's layer-freezing ladder
(``2_HistoPath_train.py:544-551``, JAX ``train/optim.py:182-190``): the
first ``n_layers_to_train`` of ``fc, resnet.layer4, …, resnet.layer1,
resnet.conv1``, plus the aggregator, train; everything else (``resnet.bn1``
always) is frozen, and so gets no weight decay and no Adam state. Frozen
stages still update their BatchNorm running statistics in train mode: the
reference's quirk, which the JAX package keeps.

``wrap_optimizer`` adds the whole-model knobs around the groups, in the
JAX package's order: ``grad_clip_norm`` clips the gradient of every
parameter by one global norm before the groups' update
(``optax.clip_by_global_norm``: ``g·max/‖g‖`` when ``‖g‖ ≥ max``), and a
``relative_lr_schedule`` multiplies every group's base LR through a
``LambdaLR`` indexed by the optimizer-step count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR


MIL_LADDER = ("fc.", "resnet.layer4.", "resnet.layer3.", "resnet.layer2.",
              "resnet.layer1.", "resnet.conv1.")


def mil_freeze_ladder(n_layers_to_train: int) -> tuple[str, ...]:
    """The trainable name prefixes of the MIL freeze ladder: the first ``n``
    ladder entries and the aggregator."""
    return MIL_LADDER[: max(0, int(n_layers_to_train))] + ("aggregator.",)


def build_grouped_optimizer(
    model: nn.Module,
    groups: Sequence[tuple[str, str | tuple[str, ...], float]],
    weight_decay: float = 0.0,
) -> torch.optim.Adam:
    """Adam over the parameters of ``model`` whose names start with a
    group's prefix (or one of its prefixes; the first matching group wins),
    each group at its own LR, all with torch's coupled ``weight_decay``.
    Unmatched parameters are frozen."""
    params: dict[str, list] = {name: [] for name, _, _ in groups}
    for pname, p in model.named_parameters():
        group = next((name for name, prefix, _ in groups
                      if pname.startswith(prefix)), None)
        if group is None:
            p.requires_grad_(False)
        else:
            params[group].append(p)
    return torch.optim.Adam(
        [{"params": params[name], "lr": float(lr), "name": name}
         for name, _, lr in groups if params[name]],
        weight_decay=float(weight_decay),
    )


def relative_lr_schedule(
    kind: str = "constant",
    *,
    total_steps: int,
    warmup_steps: int = 0,
    min_factor: float = 0.0,
    step_every: int = 0,
    step_gamma: float = 0.1,
) -> Callable[[int], float]:
    """Relative LR factor: optimizer-step count → multiplier of every
    group's base LR (``train/optim.py:82-143`` of the JAX package).

    Warmup ramps (c+1)/w over ``warmup_steps``; after it the factor decays
    1 → ``min_factor`` over the remaining steps per ``kind``: ``constant``,
    ``cosine``, ``linear``, or ``step`` (``step_gamma ** floor(steps past
    warmup / step_every)``, floored at ``min_factor``).
    """
    kinds = ("constant", "cosine", "linear", "step")
    if kind not in kinds:
        raise ValueError(f"lr_schedule={kind!r}: expected one of {kinds}")
    if kind == "step" and step_every <= 0:
        raise ValueError("lr_schedule='step' requires step_every > 0")
    if warmup_steps < 0 or total_steps <= 0:
        raise ValueError("need total_steps > 0 and warmup_steps >= 0")
    w, total = int(warmup_steps), int(total_steps)
    decay_span = max(total - w, 1)
    lo = float(min_factor)

    def schedule(count: int) -> float:
        if count < w:
            return (count + 1.0) / max(w, 1)
        progress = min(max((count - w) / decay_span, 0.0), 1.0)
        if kind == "constant":
            return 1.0
        if kind == "cosine":
            return lo + (1.0 - lo) * 0.5 * (1.0 + math.cos(math.pi * progress))
        if kind == "linear":
            return 1.0 + (lo - 1.0) * progress
        return max(step_gamma ** math.floor((count - w) / step_every), lo)

    return schedule


def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``max_norm/‖g‖`` when the global norm ``‖g‖``
    of all of them reaches ``max_norm`` (``optax.clip_by_global_norm``;
    ``clip_grad_norm_`` would add 1e-6 to the norm). No host sync. Returns
    the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


@dataclass
class TrainOptimizer:
    """The optimizer a training loop steps: the Adam groups, then optionally
    global-norm clipping before them and a relative LR schedule after."""

    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR | None = None
    grad_clip_norm: float | None = None

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip_norm is not None:
            clip_by_global_norm(self.params, self.grad_clip_norm)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": None if self.scheduler is None
                else self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])


def wrap_optimizer(
    optimizer: torch.optim.Optimizer,
    *,
    schedule: Callable[[int], float] | None = None,
    grad_clip_norm: float | None = None,
) -> TrainOptimizer:
    """The groups with the whole-model knobs around them (``wrap_optimizer``
    of the JAX package)."""
    if grad_clip_norm is not None and grad_clip_norm <= 0:
        raise ValueError("grad_clip_norm must be > 0")
    scheduler = LambdaLR(optimizer, schedule) if schedule is not None else None
    return TrainOptimizer(optimizer, scheduler,
                          None if grad_clip_norm is None else float(grad_clip_norm))
