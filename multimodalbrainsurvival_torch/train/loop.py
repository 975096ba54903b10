"""Train and eval loop.

Counterpart of ``multimodalbrainsurvival_tpu/train/loop.py:63-555,558-1179``,
one loop for every model through its adapter (``train/adapters.py``):

- ``evaluate``: the mean batch loss, the C-index per WSI and per case, and
  the reference's per-id score frame (``2_HistoPath_train.py:54-148``);
- ``train_step``: forward + backward + one optimizer step, with
  ``accumulate_steps`` interleaved microbatches ``i, i+k, …`` summed and
  divided by k (``loop.py:480-536``);
- ``train_model``: per epoch the train dataset's ``shuffle()`` where it has
  one (the patch lists inside each slide, reference ``models.py:269-272``),
  the rows shuffled with ``seed + epoch`` (the JAX package's batch order),
  train steps, train/val evals, the best model by val loss from
  ``best_from_epoch`` on, early stopping, a full train state for ``resume:
  true`` at each epoch boundary; then ``model_last`` and the last/best
  evals on every split with their ``<split>_output_{last,best}.csv``
  frames.

The random draws of training (the RNA MLP's dropout seeds, the patch
models' flips and colour jitter) come from one ``torch.Generator`` on the
adapter's ``generator_device``, seeded with ``settings.seed``; its state is
part of the saved train state, and a resume replays the dataset's
per-epoch shuffles, so a resumed run draws what an uninterrupted run
would.

The ``survival_prediction`` task is ported; ``survival_bin`` and
``classification`` raise ``NotImplementedError`` until their losses and
metrics are ported (ROADMAP.md, queue 1, item 1). The SIGTERM emergency save
and mid-epoch resume are not ported (ROADMAP.md, item 10): ``train_model``
says so on stderr when it starts, since a SIGTERM loses the work done since
the last epoch boundary.

With a ``writer`` (``--log 1``, ``utils/logging.py``) the scalars are the
JAX loop's, under its tags and steps: ``train/loss`` and
``train/bags_per_s`` at every ``log_interval``-th step, and
``<split>/<metric>`` of every evaluation at its epoch (the final ones at
``num_epochs - 1`` for the last weights and at the best epoch for the best).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.ops import metrics as M
from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss
from multimodalbrainsurvival_torch.train import checkpoint
from multimodalbrainsurvival_torch.train.optim import TrainOptimizer


@dataclass
class TrainSettings:
    num_epochs: int = 10
    task: str = "survival_prediction"
    batch_size: int = 128
    log_interval: int = 100
    save_dir: str | None = None
    output_dir: str | None = None
    reference_parity: bool = True
    seed: int = 1111
    # first epoch eligible for the best-by-val-loss checkpoint: the RNA
    # reference script saves best from epoch 0 (1_GeneExpress_train.py:
    # 196-199); only the histo script skips epoch 0
    best_from_epoch: int = 0
    # restore <save_dir>/train_state.pt and continue at the next epoch
    resume: bool = False
    # the LOGGED running loss is weighted by samples, or by the batch's
    # event count as the GeneExpress script does (1_GeneExpress_train.py:
    # 166-171); logging only
    running_loss_weight: str = "samples"
    # k microbatches per optimizer step; batch_size % k == 0
    accumulate_steps: int = 1
    # stop once the val loss has not improved by more than min_delta for
    # that many epochs (0 = never); counters restart on resume
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0


def make_loss_fn(settings: TrainSettings):
    """``(loss_fn(out, arrays, mask), label keys)`` for the settings' task.
    The serving CLIs score with the reference's Cox loss (the default
    ``reference_parity=True``), as the JAX CLIs do."""
    if settings.task == "survival_prediction":

        def loss_fn(out, arrays, mask):
            return cox_partial_likelihood_loss(
                out[:, 0],
                arrays["survival_months"],
                arrays["vital_status"],
                mask=mask,
                reference_parity=settings.reference_parity,
            )

        return loss_fn, ("survival_months", "vital_status")
    if settings.task in ("survival_bin", "classification"):
        raise NotImplementedError(
            f"task {settings.task!r} is not ported yet (ROADMAP.md, queue 1, "
            "item 1)"
        )
    raise ValueError(f"Unknown task: {settings.task!r}")


def evaluate(adapter, dataset, settings: TrainSettings, *, split: str = "val",
             writer=None, epoch: int = 0):
    """Full-split eval → ``(loss, frames, metrics)``; the metrics go to
    ``writer`` as ``<split>/<metric>`` at step ``epoch``.

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
    if writer is not None:
        for k, v in metrics.items():
            writer.scalar(f"{split}/{k}", v, epoch)
    return val_loss, frames, metrics


def train_step(adapter, optimizer: TrainOptimizer, loss_fn, arrays: dict,
               settings: TrainSettings, generator: torch.Generator) -> torch.Tensor:
    """One optimizer step on a device batch; returns the batch loss (the
    mean of the microbatch losses), detached and left on the device.

    With ``accumulate_steps = k`` microbatch i is rows ``i, i+k, i+2k, …``;
    each builds its own Cox risk set, the gradients are summed over the
    microbatches and divided by k before the one update.
    """
    k = settings.accumulate_steps
    if settings.batch_size % k:
        raise ValueError(f"accumulate_steps={k} must divide batch_size="
                         f"{settings.batch_size}")
    micro = [arrays] if k == 1 else [
        {key: v[i::k].contiguous() for key, v in arrays.items()} for i in range(k)]
    optimizer.zero_grad()
    total = None
    for mb in micro:
        out = adapter.apply(mb, train=True, generator=generator)
        loss = loss_fn(out, mb, mb[adapter.sample_mask_key])
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    if k > 1:
        for p in optimizer.params:
            if p.grad is not None:
                p.grad.div_(k)
    optimizer.step()
    return total / k


def _drain_losses(pending: list, running_loss: float, seen: float, epoch: int):
    """Fetch the deferred step losses in one device → host copy and check
    them: the reference drops into pdb on a NaN loss (models.py:107-109)."""
    if not pending:
        return running_loss, seen
    values = torch.stack([loss for loss, _, _ in pending]).cpu().numpy()
    for value, (_, weight, at_step) in zip(values, pending):
        if not np.isfinite(value):
            raise FloatingPointError(f"non-finite loss {value} at epoch {epoch} "
                                     f"step {at_step}; check inputs/LR.")
        running_loss += float(value) * weight
        seen += weight
    pending.clear()
    return running_loss, seen


def _score_frame(frames: dict):
    """The frame a train run writes: per WSI where there is one, else per
    case (``loop.py:430-432``)."""
    return frames.get("wsi", next(iter(frames.values()), None))


def train_model(adapter, datasets: dict, optimizer: TrainOptimizer,
                settings: TrainSettings, writer=None) -> dict:
    """Train ``adapter.model`` in place; returns the final frames and
    metrics (``<split>_output_{last,best}``, ``<split>_metrics_{last,best}``).
    The model ends holding the last weights. ``writer``: a
    ``MetricWriter`` or None."""
    print("train: no emergency checkpoint on SIGTERM (not ported); a SIGTERM "
          "loses the work done since the last epoch boundary", file=sys.stderr)
    loss_fn, loss_keys = make_loss_fn(settings)
    keys = tuple(dict.fromkeys(adapter.array_keys + loss_keys))
    model = adapter.model
    generator = torch.Generator(device=adapter.generator_device).manual_seed(settings.seed)
    save_dir = settings.save_dir
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    state_path = os.path.join(save_dir, "train_state.pt") if save_dir else None

    best_val_loss, best_epoch, step, start_epoch = float("inf"), -1, 0, 0
    if settings.resume and state_path and os.path.exists(state_path):
        state = checkpoint.load(state_path)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        generator.set_state(state["generator"])
        meta = state["meta"]
        step, best_val_loss, best_epoch = meta["step"], meta["best_val_loss"], meta["best_epoch"]
        start_epoch = meta["epoch"] + 1
        print(f"Resumed full train state from {state_path}: epoch {start_epoch}, "
              f"step {step}, best_val_loss {best_val_loss:.4f}")
        # the dataset's in-slide permutations advance once per epoch: bring a
        # freshly built dataset to where the uninterrupted run's would be
        if hasattr(datasets["train"], "shuffle"):
            for _ in range(start_epoch):
                datasets["train"].shuffle()

    es_best, es_stale = float("inf"), 0
    for epoch in range(start_epoch, settings.num_epochs):
        print(f"Epoch {epoch}/{settings.num_epochs - 1}")
        print("-" * 10)
        if hasattr(datasets["train"], "shuffle"):
            datasets["train"].shuffle()
        running_loss = seen = last_running_loss = last_seen = 0.0
        pending: list = []
        t_last, steps_since_log = time.time(), 0
        for batch in datasets["train"].batches(
            settings.batch_size, shuffle=True, seed=settings.seed + epoch,
            **adapter.loader_kwargs,
        ):
            arrays = adapter.to_device(batch, keys)
            mask = np.asarray(batch[adapter.sample_mask_key])
            if settings.running_loss_weight == "events" and "vital_status" in batch:
                weight = float((np.asarray(batch["vital_status"], np.float64) * mask).sum())
            else:
                weight = float(mask.sum())
            loss = train_step(adapter, optimizer, loss_fn, arrays, settings, generator)
            step += 1
            steps_since_log += 1
            # losses stay on the device until a log line or the epoch's end
            pending.append((loss, weight, step))
            if step % settings.log_interval == 0:
                running_loss, seen = _drain_losses(pending, running_loss, seen, epoch)
                # a windowed average since the last log line
                # (2_HistoPath_train.py:346-358)
                window = (running_loss - last_running_loss) / max(seen - last_seen, 1e-9)
                last_running_loss, last_seen = running_loss, seen
                speed = steps_since_log * settings.batch_size / (time.time() - t_last)
                t_last, steps_since_log = time.time(), 0
                print(f"train | epoch {epoch} | step {step} | loss {window:10.3f} "
                      f"|{speed:10.3f} bags/s")
                if writer is not None:
                    writer.scalar("train/loss", window, step)
                    writer.scalar("train/bags_per_s", speed, step)
        running_loss, seen = _drain_losses(pending, running_loss, seen, epoch)
        print(f"EPOCH Loss: {running_loss / max(seen, 1e-9):.4f}")

        for split in ("train", "val"):
            if split not in datasets:
                continue
            split_loss, _, _ = evaluate(adapter, datasets[split], settings, split=split,
                                        writer=writer, epoch=epoch)
            print(f"{split.upper()} Loss: {split_loss:.4f}")
            if split != "val":
                continue
            if split_loss < es_best - settings.early_stop_min_delta:
                es_best, es_stale = split_loss, 0
            else:
                es_stale += 1
            if split_loss < best_val_loss and (
                epoch >= settings.best_from_epoch or not settings.reference_parity
            ):
                best_epoch, best_val_loss = epoch, split_loss
                if save_dir:
                    checkpoint.save(os.path.join(save_dir, "model_dict_best.pt"),
                                    checkpoint.cpu_state_dict(model))
        if state_path:
            checkpoint.save(state_path, {
                "model": checkpoint.cpu_state_dict(model),
                "optimizer": optimizer.state_dict(),
                "generator": generator.get_state(),
                "meta": {"epoch": epoch, "step": step, "best_val_loss": best_val_loss,
                         "best_epoch": best_epoch},
            })
        if settings.early_stop_patience > 0 and es_stale >= settings.early_stop_patience:
            print(f"Early stopping at epoch {epoch}: val loss has not improved by "
                  f"> {settings.early_stop_min_delta:g} for {es_stale} epochs "
                  f"(best {es_best:.4f})")
            break

    candidates = [("last", adapter)]
    best_path = os.path.join(save_dir, "model_dict_best.pt") if save_dir else None
    if save_dir:
        checkpoint.save(os.path.join(save_dir, "model_last.pt"),
                        checkpoint.cpu_state_dict(model))
    if best_path and os.path.exists(best_path):
        print(f"LOADING BEST MODEL, best epoch = {best_epoch}")
        best_model = copy.deepcopy(model)
        best_model.load_state_dict(checkpoint.load(best_path))
        candidates.append(("best", dataclasses.replace(adapter, model=best_model)))
    else:
        candidates.append(("best", adapter))

    outputs: dict = {}
    for tag, a in candidates:
        for split in ("train", "val", "test"):
            if split not in datasets:
                continue
            _, frames, metrics = evaluate(
                a, datasets[split], settings, split=split, writer=writer,
                epoch=best_epoch if tag == "best" else settings.num_epochs - 1)
            outputs[f"{split}_output_{tag}"] = _score_frame(frames)
            outputs[f"{split}_metrics_{tag}"] = metrics
    if settings.output_dir:
        os.makedirs(settings.output_dir, exist_ok=True)
        for name, frame in outputs.items():
            if name.endswith(("_output_last", "_output_best")) and frame is not None:
                write_frame(os.path.join(settings.output_dir, f"{name}.csv"), frame,
                            index=False)
        print(f"Wrote model output files to {settings.output_dir}")
    return outputs
