"""Checkpoints with ``torch.save``, in the reference's layout.

Counterpart of ``multimodalbrainsurvival_tpu/train/checkpoint.py`` (Orbax
there). Under ``<checkpoint_path>/models/<flag>/``:

- ``model_last.pt`` and ``model_dict_best.pt``: the reference-keyed
  ``state_dict`` (``2_HistoPath_train.py:378-383``, ``1_GeneExpress_train.py:
  196-199``), CPU tensors, so the reference and the serving CLIs load them
  as they are;
- ``train_state.pt``: what ``resume: true`` needs to continue at the next
  epoch exactly: the parameters, the optimizer and scheduler state, the
  dropout-seed generator's state and the loop's bookkeeping
  (``train/loop.py:655-679`` of the JAX package).

Each file is written to a temporary name and renamed, so a crash mid-write
never leaves a torn checkpoint under the real name. Under a data- or
bag-parallel placement (``parallel.activate``) every rank calls ``save`` at
the same points: rank 0 alone writes (the parameters are replicated), then
all ranks meet at a barrier, so no rank reads a half-written file.
"""

from __future__ import annotations

import os
from typing import Any

import torch
from torch import nn

from multimodalbrainsurvival_torch.parallel import mesh as parallel


def save(path: str, obj: Any) -> None:
    put = parallel.active()
    if put is None or put.mesh.rank == 0:
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)
    if put is not None:
        put.mesh.barrier()


def load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def cpu_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
