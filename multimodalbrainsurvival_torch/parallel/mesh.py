"""Process meshes over ``torch.distributed`` and batch placement.

Counterpart of ``multimodalbrainsurvival_tpu/parallel/mesh.py``. The JAX
package lays a ``(dp, mp)`` device mesh over the devices of one or more
processes and lets GSPMD insert the collectives; here every device is a
process of its own (one rank), started by ``python -m
torch.distributed.run --nproc_per_node N`` or ``launch.spawn``, and the
collectives are explicit:

- ``initialize_from_env`` joins the process group from the launcher's
  variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``). The backend follows from the placement alone and is
  printed before the first collective: ``nccl`` when every rank of the
  node has a card of its own, ``gloo`` when ranks share a card or run on
  the CPU (``gloo`` collectives on card tensors go through the host).
- ``Mesh``: ``dp x mp`` ranks, rank ``r`` at ``(r // mp, r % mp)`` (the JAX
  ``make_mesh``'s ``reshape(dp, mp)``), with its ``dp`` group (the ranks
  of one ``mp`` column: distinct batch rows) and ``mp`` group (the ranks
  of one ``dp`` row).
- ``batch_device_put(mesh, shard_bag)``: every rank reads the same global
  host batch and keeps its rows of the sample axis (and, with
  ``shard_bag``, its ``bag / mp`` patches), the JAX multi-process
  semantics of ``host_to_global`` (``mesh.py:91-105``).
- ``global_to_host``: an all-gather of the sample axis, in rank order.
- A batch's ``placed_keys`` (the mesh-sharded device cache's
  ``patch_bag``) are already the rank's part: ``BatchPut`` leaves them,
  and ``whole_patch_bag`` gathers the whole one back.

While a loop runs under ``activate(put)``, the models read the placement
through the functions below, which are identities without one:
``row_offset`` (a rank's first row in the global batch: K2's mask offset),
``gather_rows`` / ``gather_bag`` (the sample or bag axis all-gathered,
the gradient carried back to the local slice), ``draw_rows`` / ``local_patches``
(random draws made for the global batch on every rank, each rank keeping
its part) and ``bn_group`` (the ranks whose patches a synced BatchNorm's
statistics span). ``reduce_gradients`` sums the gradients so that every
replicated parameter's gradient is the world-of-one gradient.

Every rank computes the same global loss, so a collective's backward must
not sum what the ranks computed alike: ``gather_rows``' backward keeps the
rank's own slice of the (replicated) gradient, and ``reduce_gradients``
sums over the ranks that hold distinct rows (``dp``) or patches (the whole
world under ``shard_bag``, for the patch encoder) only.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: how a multi-process run starts
LAUNCH_HINT = ("python -m torch.distributed.run --nproc_per_node N -m "
               "multimodalbrainsurvival_torch.cli.<name> --config cfg.json")

#: batch keys whose leading axis is the sample axis (JAX ``_BATCH_AXIS_KEYS``)
BATCH_AXIS_KEYS = {
    "patch_bag", "bag_mask", "sample_mask", "mask", "data", "rna_data",
    "feature_data", "survival_months", "vital_status", "survival_bin", "label",
}
#: the keys whose second axis is the bag, sharded over ``mp`` with ``shard_bag``
BAG_AXIS_KEYS = ("patch_bag", "bag_mask")

#: a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))


def rank_device(device: torch.device) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK % device_count`` for a card
    device, the CPU for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())


def pick_backend(device: torch.device) -> str:
    """``nccl`` when every rank on the node has a card of its own, else
    ``gloo`` (ranks on the CPU, or sharing a card: NCCL refuses two ranks
    on one device)."""
    if torch.device(device).type == "cuda" and local_world_size() <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_from_env(device: torch.device) -> str | None:
    """Join the process group from the launcher's variables; idempotent.
    Returns the backend, or None where no launcher started this process
    (no ``WORLD_SIZE``): a world of one process."""
    if dist.is_initialized():
        return dist.get_backend()
    if "WORLD_SIZE" not in os.environ:
        return None
    backend = pick_backend(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    print(f"mesh: rank {rank} of {world} on {rank_device(device)}, backend {backend} "
          f"({local_world_size()} ranks on this node, "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} cards)",
          flush=True)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, rank=rank, world_size=world, timeout=TIMEOUT)
    return backend


@dataclass(frozen=True, eq=False)
class Mesh:
    """``dp x mp`` ranks; ``dp_group`` / ``mp_group`` are None where the
    group is this rank alone (every collective over it is the identity)."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    backend: str | None
    dp_group: Any = None
    mp_group: Any = None
    world_group: Any = None

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}

    def barrier(self) -> None:
        if self.world_group is not None:
            all_reduce(torch.zeros(1, device=self.comm_device), self.world_group)

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's own small tensors live: the card for nccl,
        the host for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank must call)."""
        if self.world_group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self.comm_device)
        all_reduce(t, self.world_group, dist.ReduceOp.MAX)
        return bool(t.item())

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.world_group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.world_group,
                                   device=self.comm_device)
        return box[0]

    def broadcast_tree(self, tree, device: torch.device):
        """Rank 0's nested dict / list of tensors on every rank, its tensors
        on ``device`` (sent through the host)."""
        tree = self.broadcast_object(tree_map(lambda t: t.cpu(), tree)
                                     if self.rank == 0 else None)
        return tree_map(lambda t: t.to(device), tree)


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def world_rank() -> int | None:
    """This process's rank in a ``torch.distributed`` world of more than one
    rank, else None."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.get_rank()


def world_barrier(device: torch.device) -> None:
    """A barrier over the whole world (nothing without one)."""
    if world_rank() is None:
        return
    comm = rank_device(device) if dist.get_backend() == "nccl" else torch.device("cpu")
    dist.all_reduce(torch.zeros(1, device=comm))


def make_mesh(dp: int | None = None, mp: int = 1, *,
              device: torch.device | str = "cpu") -> Mesh:
    """The ``dp x mp`` mesh over the process group (a world of one process
    without one); ``dp`` defaults to ``world // mp``. Raises where ``dp x
    mp`` is not the world size: a mesh is one process per device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mp = int(mp)
    if dp is None:
        dp = world // mp
    if mp < 1 or dp < 1 or dp * mp != world:
        raise ValueError(
            f"mesh dp={dp} x mp={mp} needs {max(dp, 0) * mp} processes, one per device, "
            f"but the world has {world}: start it with {LAUNCH_HINT}")
    device = rank_device(device) if world > 1 else torch.device(device)
    backend = dist.get_backend() if dist.is_initialized() else None
    dp_group = mp_group = None
    if world > 1:
        # every rank creates every group, in one order
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if rank % mp == m and dp > 1:
                dp_group = g
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if rank // mp == d and mp > 1:
                mp_group = g
    return Mesh(dp, mp, rank, device, backend, dp_group, mp_group,
                dist.group.WORLD if world > 1 else None)


# --- collectives (gloo takes card tensors through the host) -----------------------


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _via_host(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if group is None:
        return t
    if _via_host(t):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    if group is None:
        return t
    src = t.cpu() if _via_host(t) else t
    kind = src.dtype
    if kind == torch.bool:  # gloo gathers no bool
        src = src.to(torch.uint8)
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(kind)
    return out.to(t.device)


def all_to_all(t: torch.Tensor, group, recv_counts: Sequence[int],
               send_counts: Sequence[int]) -> torch.Tensor:
    """The rows of ``t`` split by ``send_counts`` sent to the ranks of
    ``group`` in rank order; returns the rows received, ``recv_counts[r]``
    from rank ``r``, in rank order."""
    if group is None:
        return t
    src = (t.cpu() if _via_host(t) else t).contiguous()
    out = torch.empty((sum(recv_counts),) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=src.device)
    dist.all_to_all_single(out, src, list(recv_counts), list(send_counts), group=group)
    return out.to(t.device)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's slice of the
    gradient, which every rank computed whole and alike."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _AllReduce(torch.autograd.Function):
    """Sum over ``group`` whose result each rank uses on its own data: the
    backward sums the ranks' partial gradients (a synced BatchNorm's
    statistics)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Sum of partial products whose result every rank uses alike (a
    row-parallel layer's output): the backward is the identity."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """The identity on a tensor every rank holds whole, feeding a
    column-parallel layer: the backward sums the ranks' partial input
    gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather`` that carries the gradient back to the local slice."""
    if group is None:
        return t
    if t.requires_grad:
        return _Gather.apply(t, group, dim)
    return all_gather(t, group, dim)


def sum_partials(t: torch.Tensor, group) -> torch.Tensor:
    """``_AllReduce`` (differentiable) over ``group``."""
    return t if group is None else _AllReduce.apply(t, group)


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    return t if group is None else _ReduceFrom.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    return t if group is None else _CopyTo.apply(t, group)


# --- batch placement ---------------------------------------------------------------


class BatchPut:
    """``batch_device_put``'s function: a global host batch → this rank's
    part of it. ``mesh`` and ``shard_bag`` ride along for the loop."""

    def __init__(self, mesh: Mesh, shard_bag: bool = False):
        self.mesh = mesh
        self.shard_bag = bool(shard_bag) and mesh.mp > 1

    def __call__(self, batch: dict) -> dict:
        mesh, out = self.mesh, dict(batch)
        placed = batch.get("placed_keys", ())
        for k, v in batch.items():
            if k not in BATCH_AXIS_KEYS or k in placed or isinstance(v, (list, tuple)):
                continue
            n = v.shape[0]
            if n % mesh.dp:
                raise ValueError(f"batch of {n} rows does not split over dp={mesh.dp}: "
                                 "batch_size must be a multiple of dp")
            b = n // mesh.dp
            v = v[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
            if self.shard_bag and k in BAG_AXIS_KEYS and v.ndim >= 2:
                if v.shape[1] % mesh.mp:
                    raise ValueError(f"bag of {v.shape[1]} patches does not split over "
                                     f"mp={mesh.mp} (shard_bag)")
                g = v.shape[1] // mesh.mp
                v = v[:, mesh.mp_rank * g:(mesh.mp_rank + 1) * g]
            out[k] = v
        return out

    @property
    def bn_group(self):
        """The ranks that hold distinct patches."""
        return self.mesh.world_group if self.shard_bag else self.mesh.dp_group


def batch_device_put(mesh: Mesh, *, shard_bag: bool = False) -> BatchPut | None:
    """The placement of the train loop (``TrainSettings.device_put_fn``):
    None for a world of one (nothing to place)."""
    return BatchPut(mesh, shard_bag) if mesh.world > 1 else None


_ACTIVE: list[BatchPut] = []


@contextlib.contextmanager
def activate(put: BatchPut | None) -> Iterator[None]:
    """Run the models under ``put``'s placement (nothing with None)."""
    if put is None:
        yield
        return
    _ACTIVE.append(put)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> BatchPut | None:
    return _ACTIVE[-1] if _ACTIVE else None


def row_offset(rows: int) -> int:
    """This rank's first row in the global (micro)batch of which it holds
    ``rows``."""
    put = active()
    return 0 if put is None else put.mesh.dp_rank * rows


def dp_group():
    put = active()
    return None if put is None else put.mesh.dp_group


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The sample axis gathered over ``dp`` (the gradient to the local rows)."""
    return gather(t, dp_group(), 0)


def host_to_global(batch: dict, put: BatchPut | None) -> dict:
    """This rank's part of a global host batch (``put``'s), the batch itself
    without a placement."""
    return batch if put is None else put(batch)


def whole_patch_bag(batch: dict, put: BatchPut | None):
    """A batch's whole ``patch_bag``: the host loader's as it is, the
    mesh-sharded device cache's (the rank's part, ``placed_keys``) gathered
    from every rank (every rank must call)."""
    bags = batch["patch_bag"]
    if put is None or "patch_bag" not in batch.get("placed_keys", ()):
        return bags
    if put.shard_bag:
        bags = all_gather(bags, put.mesh.mp_group, 1)
    return all_gather(bags, put.mesh.dp_group, 0)


def global_to_host(t: torch.Tensor) -> np.ndarray:
    """``gather_rows`` on the host."""
    return gather_rows(t).cpu().numpy()


def gather_bag(feats: torch.Tensor, mask: torch.Tensor | None):
    """(B, bag / mp, D) features and their (B, bag / mp) mask of a
    bag-sharded batch → the whole bags', gathered over ``mp``; the
    gradient goes back to the local patches."""
    put = active()
    if put is None or not put.shard_bag:
        return feats, mask
    group = put.mesh.mp_group
    return gather(feats, group, 1), (None if mask is None else all_gather(mask, group, 1))


def bn_group():
    """The group a train-mode BatchNorm's statistics span: the placement's,
    None without one (``nn.BatchNorm2d``)."""
    put = active()
    return None if put is None else put.bn_group


def draw_rows(shape: Sequence[int], draw: Callable) -> torch.Tensor:
    """``draw(global shape)`` made for the global batch (``shape[0] x dp``
    rows) on every rank, this rank's rows kept: a dp run draws what the
    world-of-one run draws, and the generator advances alike everywhere."""
    put = active()
    if put is None or put.mesh.dp == 1:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * put.mesh.dp, *shape[1:]))
    return full[put.mesh.dp_rank * n:(put.mesh.dp_rank + 1) * n]


def local_patches(values: torch.Tensor, batch: int, bag: int) -> torch.Tensor:
    """Draws made for every patch of the global batch, (B·dp · bag_g, ...)
    in (sample, patch) order → this rank's (batch · bag, ...), where
    ``bag_g`` is ``bag · mp`` under ``shard_bag``, else ``bag``."""
    put = active()
    if put is None:
        return values
    mesh = put.mesh
    bag_g = bag * mesh.mp if put.shard_bag else bag
    v = values.reshape((batch * mesh.dp, bag_g) + values.shape[1:])
    v = v[mesh.dp_rank * batch:(mesh.dp_rank + 1) * batch]
    if put.shard_bag:
        v = v[:, mesh.mp_rank * bag:(mesh.mp_rank + 1) * bag]
    return v.reshape((batch * bag,) + values.shape[1:])


def global_patch_count(batch: int, bag: int) -> int:
    """The number of patches in the global batch of which this rank holds
    ``batch x bag``."""
    put = active()
    if put is None:
        return batch * bag
    return batch * put.mesh.dp * bag * (put.mesh.mp if put.shard_bag else 1)


def reduce_gradients(params: Sequence[torch.nn.Parameter],
                     bag_params: set | frozenset = frozenset()) -> None:
    """Sum the gradients of ``params`` so that each equals the world-of-one
    gradient: over ``dp`` (the ranks with distinct rows; ranks of one ``mp``
    row computed the replicated parameters alike), and for ``bag_params``
    (the patch encoder under ``shard_bag``, each rank's own patches) over
    the whole world. One flat all-reduce per group."""
    put = active()
    if put is None:
        return
    groups: dict = {}
    for p in params:
        if p.grad is None:
            continue
        world = put.shard_bag and p in bag_params
        group = put.mesh.world_group if world else put.mesh.dp_group
        if group is not None:
            groups.setdefault(id(group), (group, []))[1].append(p.grad)
    for group, grads in groups.values():
        for dtype in {g.dtype for g in grads}:
            same = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in same])
            all_reduce(flat, group)
            i = 0
            for g in same:
                g.copy_(flat[i:i + g.numel()].view_as(g))
                i += g.numel()
