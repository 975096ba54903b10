"""Train and eval loop.

Counterpart of ``multimodalbrainsurvival_tpu/train/loop.py:45-555,558-1179``,
one loop for every model through its adapter (``train/adapters.py``):

- ``make_loss_fn``: the three tasks of ``2_HistoPath_train.py:561-566``:
  ``survival_prediction`` (Cox partial likelihood), ``survival_bin`` (the
  discrete-time NLL of ``ops/nll_surv.py`` on ``survival_bin`` with
  censoring ``1 - vital_status``) and ``classification`` (the masked mean
  of softmax cross-entropy over the integer labels in ``target_label``);
- ``evaluate``: the mean batch loss, the task's metrics per WSI and per
  case (the C-index; for ``classification`` accuracy, F1 and AUC) and the
  reference's per-id score frames (``2_HistoPath_train.py:54-148``);
- ``train_step``: forward + backward + one optimizer step, with
  ``accumulate_steps`` interleaved microbatches ``i, i+k, …`` summed and
  divided by k (``loop.py:480-536``);
- ``train_model``: with ``pre_training_eval`` (early fusion) the train and
  val evals once before epoch 0, logged as epoch -1; per epoch the train
  dataset's ``shuffle()`` where it has
  one (the patch lists inside each slide, reference ``models.py:269-272``),
  the rows shuffled with ``seed + epoch`` (the JAX package's batch order),
  train steps, train/val evals, the best model by val loss from
  ``best_from_epoch`` on, early stopping, a full train state for ``resume:
  true`` at each epoch boundary; then ``model_last`` and the last/best
  evals (the best weights only where this run, or the run it resumed, kept
  a best; else the last) on every split with their
  ``<split>_output_{last,best}.csv``
  frames, per WSI for ``survival_prediction`` and ``classification`` and
  per case for ``survival_bin``, as the reference's train script keeps
  them (``2_HistoPath_train.py:124-141``).

The random draws of training (the RNA MLP's dropout seeds, the patch
models' flips and colour jitter, the transformer aggregator's dropout) come
from one ``torch.Generator`` on the adapter's ``generator_device``, seeded
with ``settings.seed``; its state is part of the saved train state, and a
resume replays the dataset's per-epoch shuffles, so a resumed run draws
what an uninterrupted run would.

Preemption (``loop.py:826-925`` of the JAX package, single process): with a
``save_dir`` and ``emergency_checkpoint`` (default on), a SIGTERM handler,
installed on the main thread for the run and then put back, sets a flag;
at the next step boundary the loop drains the pending losses, saves the
full state, the mid-epoch position ``meta.epoch_step`` and the epoch's
running-loss accumulators included, to ``train_state.pt.preempt`` (beside
``train_state.pt``, never over it), and raises ``TrainingPreempted``. A run
with ``resume: true`` takes the newer of the two files; from a mid-epoch
state it re-enters that epoch with the dataset's shuffles replayed and the
consumed batches skipped. A finished run deletes the stale ``.preempt``.
``preempt_after_steps`` acts as if the signal came at that global step.

Data and bag parallelism (``device_put_fn``, ``parallel.batch_device_put``;
JAX ``loop.py:738-915``): every rank reads the global host batch and runs
its part of it under ``parallel.activate``. The loss is the global batch's
on every rank (the outputs, labels and mask all-gathered over ``dp``; the
Cox risk set is global), the gradients are summed over the ranks with
distinct rows (``parallel.reduce_gradients``), so each equals the
world-of-one gradient, and the random draws are made for the global batch
on every rank from generators that stay alike. ``accumulate_steps = k``
keeps microbatch ``i`` = global rows ``i::k`` (local rows ``i::k``; the
rank's rows must split by k). ``evaluate`` gathers the outputs to every
rank, and rank 0 alone writes frames and checkpoints
(``train/checkpoint.py``). The preemption consensus: every rank joins a
1-int all-reduce (MAX) at every ``preempt_sync_every``-th check site,
whether or not it wants to stop, so either all ranks enter the save or
none does; every rank then raises ``TrainingPreempted``. A state saved at
one mesh shape resumes at any other, or at a world of one.

With a ``writer`` (``--log 1``, ``utils/logging.py``) the scalars are the
JAX loop's, under its tags and steps: ``train/loss`` and
``train/bags_per_s`` at every ``log_interval``-th step, and
``<split>/<metric>`` of every evaluation at its epoch (the final ones at
``num_epochs - 1`` for the last weights and at the best epoch for the best).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.ops import metrics as M
from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss
from multimodalbrainsurvival_torch.ops.nll_surv import nll_surv_loss
from multimodalbrainsurvival_torch.parallel import mesh as parallel
from multimodalbrainsurvival_torch.train import checkpoint
from multimodalbrainsurvival_torch.train.optim import TrainOptimizer


class TrainingPreempted(RuntimeError):
    """Raised after the emergency full-state save that a SIGTERM (or
    ``preempt_after_steps``) asks for; ``resume: true`` continues the run
    exactly from ``path``, at batch ``epoch_step`` of ``epoch``."""

    def __init__(self, epoch: int, epoch_step: int, path: str):
        super().__init__(
            f"training preempted at epoch {epoch}, batch {epoch_step}; full "
            f"train state saved to {path}; rerun with resume: true")
        self.epoch = epoch
        self.epoch_step = epoch_step
        self.path = path


@dataclass
class TrainSettings:
    num_epochs: int = 10
    task: str = "survival_prediction"
    # the head's width: survival_bin's bins, classification's classes
    num_classes: int = 1
    # classification's label column
    target_label: str = "vital_status"
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
    # restore the newer of <save_dir>/train_state.pt and its .preempt
    # sibling and continue where it stopped
    resume: bool = False
    # SIGTERM → a full-state save at the next step boundary, then
    # TrainingPreempted (needs save_dir)
    emergency_checkpoint: bool = True
    # act as if SIGTERM came once the global step reaches this (0 = never)
    preempt_after_steps: int = 0
    # the LOGGED running loss is weighted by samples, or by the batch's
    # event count as the GeneExpress script does (1_GeneExpress_train.py:
    # 166-171); logging only
    running_loss_weight: str = "samples"
    # evaluate train and val once before the first epoch, logged as epoch
    # -1, as the EarlyFusion script does (2_EarlyFusion_train.py:311-312);
    # logging only
    pre_training_eval: bool = False
    # k microbatches per optimizer step; batch_size % k == 0
    accumulate_steps: int = 1
    # stop once the val loss has not improved by more than min_delta for
    # that many epochs (0 = never); the counters are part of the saved
    # state, as of the last epoch boundary
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    # a torch.profiler trace (CPU and CUDA) of that many train steps after
    # warmup, written under profile_dir (0 = none)
    profile_steps: int = 0
    profile_dir: str = "torch_trace"
    # each step under autograd's anomaly mode, its loss checked
    debug_checkify: bool = False
    # the data- or bag-parallel placement (parallel.batch_device_put), or
    # None for a world of one
    device_put_fn: Any = None
    # a multi-rank run agrees on a preemption at every n-th check site
    preempt_sync_every: int = 8


def make_loss_fn(settings: TrainSettings, group=None):
    """``(loss_fn(out, arrays, mask), label keys)`` for the settings' task
    (``loop.py:199-219`` of the JAX package). The serving CLIs score with
    the reference's Cox loss (the default ``reference_parity=True``), as
    the JAX CLIs do. With a ``group`` (a mesh's ``dp`` group) the arrays
    are a rank's rows and the loss is the global batch's: the outputs (with
    their gradient), the labels and the mask are gathered over it."""
    if settings.task == "survival_prediction":

        def loss_fn(out, arrays, mask):
            return cox_partial_likelihood_loss(
                out[:, 0],
                arrays["survival_months"],
                arrays["vital_status"],
                mask=mask,
                reference_parity=settings.reference_parity,
                group=group,
            )

        return loss_fn, ("survival_months", "vital_status")
    local_fn, keys = _local_loss_fn(settings)
    if group is None:
        return local_fn, keys

    def loss_fn(out, arrays, mask):
        return local_fn(parallel.gather(out, group),
                        {k: parallel.gather(arrays[k], group) for k in keys},
                        parallel.gather(mask, group))

    return loss_fn, keys


def _local_loss_fn(settings: TrainSettings):
    """``make_loss_fn``'s non-Cox tasks on the arrays as given."""
    if settings.task == "survival_bin":

        def loss_fn(out, arrays, mask):
            censoring = 1.0 - arrays["vital_status"].float()
            return nll_surv_loss(out, arrays["survival_bin"], censoring, mask=mask)

        return loss_fn, ("survival_bin", "vital_status")
    if settings.task == "classification":
        label = settings.target_label

        def loss_fn(out, arrays, mask):
            ce = F.cross_entropy(out.float(), arrays[label].long(), reduction="none")
            m = mask.float()
            return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)

        return loss_fn, (label,)
    raise ValueError(f"Unknown task: {settings.task!r}")


def host_array(batch: dict, key: str) -> np.ndarray:
    """A batch's array on the host: the device cache's ``host_<key>``
    mirror where the batch has one (its arrays are on the card)."""
    return np.asarray(batch.get("host_" + key, batch[key]))


def evaluate(adapter, dataset, settings: TrainSettings, *, split: str = "val",
             writer=None, epoch: int = 0):
    """Full-split eval → ``(loss, frames, metrics)``; the metrics go to
    ``writer`` as ``<split>/<metric>`` at step ``epoch``.

    ``loss`` is the unweighted mean of the batch losses, as the reference's
    ``np.mean(loss_list)`` (``2_HistoPath_train.py:148``); the padded final
    batch gives the same per-batch loss as torch's ragged one. ``frames``
    holds the task's score frame per level, ``"wsi"`` and ``"case"``
    (``default_frame`` picks the one a train run writes). Under a placement
    (``settings.device_put_fn``) each rank scores its part of every batch
    and the outputs are gathered to every rank.
    """
    loss_fn, loss_keys = make_loss_fn(settings)
    put = settings.device_put_fn
    keys = tuple(dict.fromkeys(adapter.array_keys + loss_keys))
    label_keys = tuple(dict.fromkeys(
        loss_keys + (settings.target_label, "survival_months", "vital_status")))
    outputs, losses, masks = [], [], []
    ids: dict[str, list] = {k: [] for k in adapter.id_keys}
    labels: dict[str, list] = {}
    for batch in dataset.batches(settings.batch_size, **adapter.loader_kwargs):
        if put is None:
            arrays = adapter.to_device(batch, keys)
            out = adapter.apply(arrays)
        else:
            with parallel.activate(put):
                out = parallel.gather_rows(adapter.apply(adapter.to_device(put(batch), keys)))
            arrays = adapter.to_device(batch, loss_keys + (adapter.sample_mask_key,))
        losses.append(loss_fn(out, arrays, arrays[adapter.sample_mask_key]))
        outputs.append(out)
        mask = host_array(batch, adapter.sample_mask_key)
        masks.append(mask)
        for k in adapter.id_keys:
            ids[k].extend(v for v, m in zip(batch[k], mask) if m)
        for k in label_keys:
            if k in batch:
                labels.setdefault(k, []).extend(host_array(batch, k)[mask].tolist())

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
        if settings.task == "classification":
            acc, f1, auc, frames[level] = M.classification_scores(
                outputs, ids[key], np.array(labels[settings.target_label]))
            metrics.update({f"{level}_acc": acc, f"{level}_f1": f1,
                            f"{level}_auc": auc})
            print(f"{split} {level}  | acc {acc:.3f} | f1 {f1:.3f} | auc {auc:.3f}")
            continue
        if settings.task == "survival_bin":
            ci, frames[level] = M.nllsurv_ci(outputs, status, months, ids[key],
                                             settings.num_classes)
        else:
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
    microbatches and divided by k before the one update. With
    ``debug_checkify`` the step runs under autograd's anomaly mode (a
    backward that makes a NaN raises, naming its function and the forward
    op's traceback), and a non-finite loss raises before the backward.
    """
    k = settings.accumulate_steps
    put = settings.device_put_fn
    rows = settings.batch_size // (1 if put is None else put.mesh.dp)
    if settings.batch_size % k or rows % k:
        raise ValueError(f"accumulate_steps={k} must divide batch_size="
                         f"{settings.batch_size}" + ("" if put is None else
                                                     f" / dp={put.mesh.dp}"))
    micro = [arrays] if k == 1 else [
        {key: v[i::k].contiguous() for key, v in arrays.items()} for i in range(k)]
    optimizer.zero_grad()
    total = None
    checking = (torch.autograd.detect_anomaly(check_nan=True) if settings.debug_checkify
                else contextlib.nullcontext())
    with checking:
        for mb in micro:
            out = adapter.apply(mb, train=True, generator=generator)
            loss = loss_fn(out, mb, mb[adapter.sample_mask_key])
            if settings.debug_checkify and not torch.isfinite(loss).item():
                # anomaly mode checks the backward alone: a forward that
                # made the loss non-finite is named here
                raise FloatingPointError(
                    f"debug_checkify: the forward made the loss {loss.item()} (a nan or "
                    "inf in the step's inputs or activations)")
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
    if put is not None:
        parallel.reduce_gradients(optimizer.params, _bag_params(adapter, put))
    if k > 1:
        for p in optimizer.params:
            if p.grad is not None:
                p.grad.div_(k)
    optimizer.step()
    return total / k


def _bag_params(adapter, put) -> frozenset:
    """The parameters of the patch encoder, which under ``shard_bag`` sees
    this rank's patches alone."""
    resnet = getattr(adapter.model, "resnet", None)
    if not put.shard_bag or resnet is None:
        return frozenset()
    return frozenset(resnet.parameters())


class StepTrace:
    """A ``torch.profiler`` trace (CPU, and CUDA on a card) of
    ``settings.profile_steps`` train steps, JAX ``train/loop.py:640-646,
    932-941,1004-1012``: it starts at global step ``warmup`` and stops after
    ``profile_steps`` steps, or at ``stop()`` when the run ends first, so a
    started trace is always written, as ``<profile_dir>/train_steps_<a>-<b>
    .pt.trace.json`` (Chrome trace format)."""

    def __init__(self, settings: TrainSettings, warmup: int, device: torch.device):
        self.steps = settings.profile_steps
        self.dir = settings.profile_dir
        self.warmup = warmup
        self.cuda = torch.device(device).type == "cuda"
        self.profiler = None
        self.done = False
        self.first = self.last = 0

    def before_step(self, step: int) -> None:
        if self.steps and not self.done and self.profiler is None and step >= self.warmup:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.start()
            self.first = self.last = step

    def after_step(self, step: int) -> None:
        """``step``: the global step just taken, counted from 1."""
        if self.profiler is not None:
            self.last = step
            if step >= self.first + self.steps:
                self.stop()

    def stop(self) -> None:
        if self.profiler is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.profiler.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.profiler.export_chrome_trace(os.path.join(
            self.dir, f"train_steps_{self.first}-{self.last}.pt.trace.json"))
        self.profiler, self.done = None, True
        print(f"wrote profiler trace to {self.dir}", flush=True)


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


def default_frame(frames: dict, task: str):
    """The frame a train run writes: per WSI for ``survival_prediction`` and
    ``classification``, per case for ``survival_bin``, as the reference's
    train script keeps them (``loop.py:386-433`` of the JAX package); the
    other level where a dataset has one only."""
    want = "case" if task == "survival_bin" else "wsi"
    return frames.get(want, next(iter(frames.values()), None))


def train_model(adapter, datasets: dict, optimizer: TrainOptimizer,
                settings: TrainSettings, writer=None) -> dict:
    """Train ``adapter.model`` in place; returns the final frames and
    metrics (``<split>_output_{last,best}``, ``<split>_metrics_{last,best}``).
    The model ends holding the last weights. ``writer``: a
    ``MetricWriter`` or None. Raises ``TrainingPreempted`` after an
    emergency save (module docstring)."""
    with parallel.activate(settings.device_put_fn):
        return _train_model(adapter, datasets, optimizer, settings, writer)


def _train_model(adapter, datasets: dict, optimizer: TrainOptimizer,
                 settings: TrainSettings, writer) -> dict:
    put = settings.device_put_fn
    mesh = None if put is None else put.mesh
    loss_fn, loss_keys = make_loss_fn(settings, None if mesh is None else mesh.dp_group)
    keys = tuple(dict.fromkeys(adapter.array_keys + loss_keys))
    model = adapter.model
    train_set = datasets["train"]
    reshuffles = hasattr(train_set, "shuffle")
    generator = torch.Generator(device=adapter.generator_device).manual_seed(settings.seed)
    save_dir = settings.save_dir
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    state_path = os.path.join(save_dir, "train_state.pt") if save_dir else None
    preempt_path = f"{state_path}.preempt" if state_path else None

    best_val_loss, best_epoch, step, start_epoch = float("inf"), -1, 0, 0
    # early stopping: the raw minimum val loss and the epochs since it, as
    # of the last epoch boundary in the saved state
    es_best, es_stale = float("inf"), 0
    es_saved = (es_best, es_stale)
    # (state_epoch, epoch_step) describe completed work: (-1, 0) nothing;
    # (E, 0) epoch E done; (E, k > 0) k batches of epoch E done
    state_epoch, epoch_step = -1, 0
    # a mid-epoch resume: the epoch's shuffle() ran and its accumulators
    # come with the state
    mid_epoch = False
    # the epoch's running-loss accumulators, and those of its last log line
    running_loss = seen = last_running_loss = last_seen = 0.0
    pending: list = []

    def full_state() -> dict:
        return {
            "model": checkpoint.cpu_state_dict(model),
            "optimizer": optimizer.state_dict(),
            "generator": generator.get_state(),
            "meta": {"epoch": state_epoch, "step": step, "epoch_step": epoch_step,
                     "best_val_loss": best_val_loss, "best_epoch": best_epoch,
                     "es_best": es_saved[0], "es_stale": es_saved[1],
                     "running_loss": running_loss, "seen": seen,
                     "last_running_loss": last_running_loss, "last_seen": last_seen},
        }

    # the newer of the boundary state and an emergency one
    saved = [p for p in (state_path, preempt_path) if p and os.path.exists(p)]
    restore_from = max(saved, key=os.path.getmtime) if settings.resume and saved else None
    if restore_from:
        state = checkpoint.load(restore_from)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        generator.set_state(state["generator"])
        meta = state["meta"]
        step, best_val_loss, best_epoch = meta["step"], meta["best_val_loss"], meta["best_epoch"]
        es_best = meta.get("es_best", es_best)
        es_stale = meta.get("es_stale", es_stale)
        es_saved = (es_best, es_stale)
        state_epoch, epoch_step = meta["epoch"], meta.get("epoch_step", 0)
        mid_epoch = epoch_step > 0
        if mid_epoch:
            # re-enter that epoch, whose shuffle() already ran, skip the
            # batches already consumed and carry its accumulators
            start_epoch = state_epoch
            shuffles_done = state_epoch + 1
            running_loss, seen, last_running_loss, last_seen = (
                meta[k] for k in ("running_loss", "seen", "last_running_loss",
                                  "last_seen"))
        else:
            start_epoch = shuffles_done = state_epoch + 1
        print(f"Resumed full train state from {restore_from}: epoch {start_epoch}"
              + (f" (batch {epoch_step})" if mid_epoch else "")
              + f", step {step}, best_val_loss {best_val_loss:.4f}")
        # the dataset's in-slide permutations advance once per epoch: bring a
        # freshly built dataset to where the interrupted run's was
        if reshuffles:
            for _ in range(shuffles_done):
                train_set.shuffle()

    # the trace's warmup: 5 steps, fewer on a run too short for them and
    # the trace (JAX loop.py:932-941); a resumed run is warm already
    warmup = 5
    if settings.profile_steps:
        per_epoch = -(-len(train_set) // settings.batch_size)
        total = step + per_epoch * (settings.num_epochs - start_epoch)
        warmup = max(step, min(5, total - settings.profile_steps))
    trace = StepTrace(settings, warmup, adapter.device)

    if settings.pre_training_eval and start_epoch == 0:
        for split in ("train", "val"):
            if split in datasets:
                split_loss, _, _ = evaluate(adapter, datasets[split], settings,
                                            split=split, writer=writer, epoch=-1)
                print(f"{split.upper()} Loss: {split_loss:.4f}")

    preempt_flag = threading.Event()
    prev_handler, handler_installed = None, False
    # a multi-rank run: every rank joins the consensus at the aligned check
    # sites, whether or not it wants to stop (JAX loop.py:832-915)
    consensus = bool(mesh is not None and save_dir and settings.emergency_checkpoint)
    sites = 0
    if save_dir and settings.emergency_checkpoint:
        def on_sigterm(signum, frame):
            preempt_flag.set()
            print("preemption signal received: checkpointing at the next step "
                  "boundary...", flush=True)

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
            handler_installed = True
        except ValueError:
            pass  # not the main thread: no signal-driven preemption

    def maybe_preempt() -> None:
        """Between steps: on a preemption request, save the full state to
        the ``.preempt`` sibling and raise."""
        nonlocal running_loss, seen, sites
        if not (save_dir and settings.emergency_checkpoint):
            return
        want = preempt_flag.is_set() or bool(settings.preempt_after_steps
                                             and step >= settings.preempt_after_steps)
        if consensus:
            sites += 1
            if sites % max(settings.preempt_sync_every, 1):
                return
            if not mesh.any_rank(want):
                return
            if not want:
                print("a peer rank asked for preemption: joining the emergency save",
                      flush=True)
        elif not want:
            return
        running_loss, seen = _drain_losses(pending, running_loss, seen, state_epoch)
        t0 = time.perf_counter()
        checkpoint.save(preempt_path, full_state())
        print(f"PREEMPTED: saved full train state (epoch {state_epoch}, batch "
              f"{epoch_step}, global step {step}) to {preempt_path} in "
              f"{time.perf_counter() - t0:.3f} s "
              f"({os.path.getsize(preempt_path) / 1e6:.1f} MB); rerun with "
              "resume: true to continue exactly", flush=True)
        raise TrainingPreempted(state_epoch, epoch_step, preempt_path)

    try:
        for epoch in range(start_epoch, settings.num_epochs):
            # a request that came during the last epoch's evals saves here
            maybe_preempt()
            print(f"Epoch {epoch}/{settings.num_epochs - 1}")
            print("-" * 10)
            skip = epoch_step if mid_epoch else 0
            if not mid_epoch:
                if reshuffles:
                    train_set.shuffle()
                epoch_step = 0
                running_loss = seen = last_running_loss = last_seen = 0.0
            mid_epoch = False
            pending = []
            t_last, steps_since_log = time.time(), 0
            batches = train_set.batches(
                settings.batch_size, shuffle=True, seed=settings.seed + epoch,
                skip_batches=skip, **adapter.loader_kwargs)
            try:
                for batch in batches:
                    maybe_preempt()
                    arrays = adapter.to_device(batch if put is None else put(batch), keys)
                    mask = host_array(batch, adapter.sample_mask_key)
                    if settings.running_loss_weight == "events" and "vital_status" in batch:
                        weight = float((host_array(batch, "vital_status").astype(np.float64)
                                        * mask).sum())
                    else:
                        weight = float(mask.sum())
                    trace.before_step(step)
                    loss = train_step(adapter, optimizer, loss_fn, arrays, settings,
                                      generator)
                    step += 1
                    trace.after_step(step)
                    epoch_step += 1
                    state_epoch = epoch
                    steps_since_log += 1
                    # losses stay on the device until a log line or the epoch's end
                    pending.append((loss, weight, step))
                    if step % settings.log_interval == 0:
                        running_loss, seen = _drain_losses(pending, running_loss, seen,
                                                           epoch)
                        # a windowed average since the last log line
                        # (2_HistoPath_train.py:346-358)
                        window = (running_loss - last_running_loss) / max(
                            seen - last_seen, 1e-9)
                        last_running_loss, last_seen = running_loss, seen
                        speed = steps_since_log * settings.batch_size / (
                            time.time() - t_last)
                        t_last, steps_since_log = time.time(), 0
                        print(f"train | epoch {epoch} | step {step} | loss "
                              f"{window:10.3f} |{speed:10.3f} bags/s", flush=True)
                        if writer is not None:
                            writer.scalar("train/loss", window, step)
                            writer.scalar("train/bags_per_s", speed, step)
                    maybe_preempt()
            finally:
                # stops and joins the loader's producer thread, also when a
                # preemption leaves the loop
                batches.close()
            running_loss, seen = _drain_losses(pending, running_loss, seen, epoch)
            print(f"EPOCH Loss: {running_loss / max(seen, 1e-9):.4f}")

            for split in ("train", "val"):
                if split not in datasets:
                    continue
                split_loss, _, _ = evaluate(adapter, datasets[split], settings,
                                            split=split, writer=writer, epoch=epoch)
                print(f"{split.upper()} Loss: {split_loss:.4f}")
                if split == "val":
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
                # the state is still (epoch, all its batches): a resume from
                # here re-runs the epoch's evals and best-model bookkeeping
                maybe_preempt()
            state_epoch, epoch_step = epoch, 0
            es_saved = (es_best, es_stale)
            if state_path:
                checkpoint.save(state_path, full_state())
            if settings.early_stop_patience > 0 and es_stale >= settings.early_stop_patience:
                print(f"Early stopping at epoch {epoch}: val loss has not improved by "
                      f"> {settings.early_stop_min_delta:g} for {es_stale} epochs "
                      f"(best {es_best:.4f})")
                break
    finally:
        trace.stop()
        if handler_installed:
            # None: the previous handler was not installed from Python
            signal.signal(signal.SIGTERM,
                          prev_handler if prev_handler is not None else signal.SIG_DFL)

    candidates = [("last", adapter)]
    best_path = os.path.join(save_dir, "model_dict_best.pt") if save_dir else None
    if save_dir:
        checkpoint.save(os.path.join(save_dir, "model_last.pt"),
                        checkpoint.cpu_state_dict(model))
        # a finished run: an emergency state from before is stale
        if (mesh is None or mesh.rank == 0) and os.path.exists(preempt_path):
            os.remove(preempt_path)
    # only a best this run kept (or a resumed run restored): a file left in
    # save_dir by an earlier run is not this run's best
    if best_path and best_epoch >= 0 and os.path.exists(best_path):
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
            outputs[f"{split}_output_{tag}"] = default_frame(frames, settings.task)
            outputs[f"{split}_metrics_{tag}"] = metrics
    if settings.output_dir and (mesh is None or mesh.rank == 0):
        os.makedirs(settings.output_dir, exist_ok=True)
        for name, frame in outputs.items():
            if name.endswith(("_output_last", "_output_best")) and frame is not None:
                write_frame(os.path.join(settings.output_dir, f"{name}.csv"), frame,
                            index=False)
        print(f"Wrote model output files to {settings.output_dir}")
    return outputs
