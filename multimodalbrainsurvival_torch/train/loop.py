"""Eval loop and loss selection (serving path).

Counterpart of ``multimodalbrainsurvival_tpu/train/loop.py:64-220,270-433``:
``TrainSettings`` (the fields evaluation reads), ``make_loss_fn`` and
``evaluate`` — the mean batch loss, the C-index per WSI and per case, and
the reference's per-id score frame (``2_HistoPath_train.py:54-148``).

The ``survival_prediction`` task is ported; ``survival_bin`` and
``classification`` raise ``NotImplementedError`` until their losses and
metrics are ported (ROADMAP.md, queue 1, item 1). Training comes with the training
slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from multimodalbrainsurvival_torch.ops import metrics as M
from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss


@dataclass
class TrainSettings:
    task: str = "survival_prediction"
    batch_size: int = 128


def make_loss_fn(settings: TrainSettings):
    """``(loss_fn(out, arrays, mask), label keys)`` for the settings' task.
    The serving CLIs score with the reference's Cox loss
    (``reference_parity=True``), as the JAX CLIs do."""
    if settings.task == "survival_prediction":

        def loss_fn(out, arrays, mask):
            return cox_partial_likelihood_loss(
                out[:, 0],
                arrays["survival_months"],
                arrays["vital_status"],
                mask=mask,
            )

        return loss_fn, ("survival_months", "vital_status")
    if settings.task in ("survival_bin", "classification"):
        raise NotImplementedError(
            f"task {settings.task!r} is not ported yet (ROADMAP.md, queue 1, "
            "item 1)"
        )
    raise ValueError(f"Unknown task: {settings.task!r}")


def evaluate(adapter, dataset, settings: TrainSettings, *, split: str = "val"):
    """Full-split eval → ``(loss, frames, metrics)``.

    ``loss`` is the unweighted mean of the batch losses, as the reference's
    ``np.mean(loss_list)`` (``2_HistoPath_train.py:148``); the padded final
    batch gives the same per-batch loss as torch's ragged one. ``frames``
    holds the score frame per level, ``"wsi"`` and ``"case"``.
    """
    loss_fn, loss_keys = make_loss_fn(settings)
    keys = tuple(dict.fromkeys(adapter.array_keys + loss_keys))
    outputs, losses, masks = [], [], []
    ids: dict[str, list] = {k: [] for k in adapter.id_keys}
    labels: dict[str, list] = {}
    for batch in dataset.batches(settings.batch_size, **adapter.loader_kwargs):
        arrays = adapter.to_device(batch, keys)
        out = adapter.apply(arrays)
        losses.append(loss_fn(out, arrays, arrays[adapter.sample_mask_key]))
        outputs.append(out)
        mask = np.asarray(batch[adapter.sample_mask_key])
        masks.append(mask)
        for k in adapter.id_keys:
            ids[k].extend(v for v, m in zip(batch[k], mask) if m)
        for k in loss_keys:
            if k in batch:
                labels.setdefault(k, []).extend(np.asarray(batch[k])[mask].tolist())

    if not losses:
        print(f"{split}  | empty split, no evaluation")
        return float("nan"), {}, {"loss": float("nan")}
    # one device → host copy for the whole split
    losses = torch.stack(losses).cpu().numpy()
    outputs = torch.cat(outputs).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        # the reference drops into pdb on a NaN loss (models.py:107-109)
        bad = int(np.flatnonzero(~np.isfinite(losses))[0])
        raise FloatingPointError(
            f"non-finite eval loss {float(losses[bad])} in split {split!r} "
            f"batch {bad} (task={settings.task})"
        )
    outputs = outputs[np.concatenate(masks)]
    val_loss = float(np.mean(losses))
    months = np.array(labels.get("survival_months", []))
    status = np.array(labels.get("vital_status", []))

    metrics: dict[str, float] = {"loss": val_loss}
    frames: dict[str, dict] = {}
    for key in adapter.id_keys:
        if not ids.get(key):
            continue
        level = "wsi" if key == "WSI" else "case"
        ci, frames[level] = M.survival_ci(outputs, ids[key], months, status)
        metrics[f"{level}_CI"] = ci
        print(f"{split} {level}  | CI {ci:.3f}")
    return val_loss, frames, metrics
