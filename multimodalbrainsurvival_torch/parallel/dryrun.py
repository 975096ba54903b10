"""The multichip dry run: one joint step with data, tensor and bag
parallelism together, held against the same step in one process.

Counterpart of ``__graft_entry__.py:95-240`` (``dryrun_multichip``) of the
JAX package, at its tiny shapes and mesh: ``mp = 2`` when the world has at
least 2 ranks, ``dp = world / mp``; a ``BagHistopathologyRNAModel``
(ResNet-18, the RNA encoder 128 → 32 → 64 with dropout 0.5, sharded by
``parallel/sharding.py``), ``2·dp`` cases of ``2·mp`` 32-px patches, the
bag sharded over ``mp``. Every rank also runs the step unsharded on the
whole batch (its world-of-one reference, no collective) and checks the
loss, the gradients of everything above the ResNet (the tensor-parallel
ones gathered) and the synced BatchNorm statistics against it, and
reports the ResNet's largest relative gradient difference; then one Adam
step. (The ResNet's gradients are not judged here: a ReLU input within
rounding of zero, which the synced statistics' other summation order can
flip, moves a gradient by a whole element's share. The CPU tests hold
them at sizes where no input lies that close.) Sub-checks: a bag-sharded
MIL step (``16·mp`` patches a bag), held against its reference the same
way; the mesh-sharded device cache (``data/device_cache.py``, the bag
sharded over ``mp``), whose batches over two shuffled epochs must equal
the host loader's placed by ``BatchPut`` and whose first batch takes a
MIL step held against the one-process step on the host loader's batch;
and an elastic resume: an RNA ``train_model`` run over ``(world, 1)``
preempted after 2 steps and resumed over ``(world / 2, 2)``, which must
end with the weights of the uninterrupted run in one process.

``python -m multimodalbrainsurvival_torch.parallel.dryrun --world 4
[--device cpu]`` starts the world itself (``parallel/launch.py``; gloo on
the CPU or on ranks that share a card) and prints rank 0's line::

    dryrun_multichip OK: mesh={'dp': 2, 'mp': 2}, loss=..., devices=4, subchecks=[...]
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

import numpy as np
import torch

from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.models import (
    AggregationModel,
    BagHistopathologyRNAModel,
    RNAEncoder,
    RNAOnlyModel,
    make_aggregator,
)
from multimodalbrainsurvival_torch.models.resnet import resnet18
from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss
from multimodalbrainsurvival_torch.parallel import launch
from multimodalbrainsurvival_torch.parallel import mesh as parallel
from multimodalbrainsurvival_torch.parallel.sharding import (
    gathered_state_dict,
    joint_param_shardings,
    shard_model,
)

#: float32 agreement of the sharded step with the one-process step: the
#: loss (relative), each judged gradient (relative, and absolute against
#: the largest gradient), the BatchNorm statistics (absolute)
RTOL, ATOL_SCALE, STATS_TOL = 1e-4, 1e-5, 1e-5
SEED = 0
MODULE = "multimodalbrainsurvival_torch.parallel.dryrun"


def _joint_batch(dp: int, mp: int, device) -> dict:
    rng = np.random.default_rng(SEED)
    B, bag, hw, genes = 2 * dp, 2 * mp, 32, 128
    return {
        "x": torch.tensor(rng.normal(size=(B, bag, 3, hw, hw)), dtype=torch.float32,
                          device=device).contiguous(memory_format=torch.contiguous_format),
        "mask": torch.ones((B, bag), dtype=torch.bool, device=device),
        "rna": torch.tensor(rng.normal(size=(B, genes)), dtype=torch.float32, device=device),
        "time": torch.tensor(rng.uniform(1, 100, B), dtype=torch.float32, device=device),
        "event": torch.ones(B, dtype=torch.float32, device=device),
    }


def _local(batch: dict, mesh: parallel.Mesh, shard_bag: bool) -> dict:
    """This rank's rows (and patches) of the global batch."""
    b = batch["x"].shape[0] // mesh.dp
    rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
    out = {k: v[rows] for k, v in batch.items()}
    if shard_bag:
        g = batch["x"].shape[1] // mesh.mp
        patches = slice(mesh.mp_rank * g, (mesh.mp_rank + 1) * g)
        out["x"], out["mask"] = out["x"][:, patches], out["mask"][:, patches]
    return out


def _step(model, batch: dict, seed: int, group=None) -> torch.Tensor:
    model.train()
    model.zero_grad(set_to_none=True)
    if isinstance(model, BagHistopathologyRNAModel):
        out = model(batch["x"], batch["rna"], batch["mask"], seed=seed)
    else:
        out, _ = model(batch["x"], batch["mask"])
    loss = cox_partial_likelihood_loss(out[:, 0], batch["time"], batch["event"], group=group)
    loss.backward()
    return loss.detach()


def _compare(model, reference, loss, ref_loss, plan: dict, mesh, label: str) -> float:
    """Loss, gradients above the ResNet and BatchNorm statistics of the
    sharded step against the one-process step; returns the ResNet's
    largest gradient difference relative to its gradient's scale."""
    if not np.isclose(float(loss), float(ref_loss), rtol=RTOL):
        raise AssertionError(f"{label}: loss {float(loss)} vs one process {float(ref_loss)}")
    tp = getattr(getattr(model, "rna_mlp", None), "tp", None)
    grads = dict(model.named_parameters())
    ref = dict(reference.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in ref.values() if p.grad is not None)
    worst = 0.0
    for name, p in ref.items():
        if p.grad is None:
            continue
        g = grads[name].grad
        if tp is not None and plan.get(name) is not None:
            g = parallel.all_gather(g, tp.mp_group, plan[name])
        diff = float((g - p.grad).abs().max())
        if name.startswith("resnet."):
            worst = max(worst, diff / max(float(p.grad.abs().max()), 1e-30))
        elif not torch.allclose(g, p.grad, rtol=RTOL, atol=scale * ATOL_SCALE):
            raise AssertionError(f"{label}: gradient of {name} differs by {diff}")
    state = gathered_state_dict(model)
    for name, v in reference.state_dict().items():
        if "running" in name and float((state[name] - v).abs().max()) > STATS_TOL:
            raise AssertionError(f"{label}: BatchNorm {name} differs from one process")
    return worst


def joint_step(mesh: parallel.Mesh) -> tuple[float, float]:
    """The joint model's step over ``mesh`` with dp, TP and the bag sharded;
    returns the loss and the ResNet's largest relative gradient
    difference."""
    device = mesh.device
    torch.manual_seed(SEED)
    model = BagHistopathologyRNAModel(
        resnet18(num_classes=None), RNAEncoder(128, (32, 64), dropout=0.5)).to(device)
    reference = copy.deepcopy(model)
    batch = _joint_batch(mesh.dp, mesh.mp, device)
    seed = 1234
    ref_loss = _step(reference, batch, seed)
    shard_model(model, mesh)
    put = parallel.BatchPut(mesh, shard_bag=True)
    with parallel.activate(put):
        loss = _step(model, _local(batch, mesh, put.shard_bag), seed, mesh.dp_group)
        parallel.reduce_gradients(list(model.parameters()),
                                  frozenset(model.resnet.parameters()))
    resnet_diff = _compare(model, reference, loss, ref_loss,
                           joint_param_shardings(reference), mesh, "joint step")
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    optimizer.step()
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("joint step: non-finite weights after the Adam step")
    return float(loss), resnet_diff


def bag_sharded_mil(mesh: parallel.Mesh) -> None:
    """A MIL step (ResNet-18, attention) with ``16·mp`` patches a bag,
    sharded over ``mp``: no rank holds a whole bag."""
    device = mesh.device
    rng = np.random.default_rng(5)
    B, bag, hw = 2 * mesh.dp, 16 * mesh.mp, 16
    torch.manual_seed(6)
    model = AggregationModel(resnet18(num_classes=None),
                             make_aggregator("attention", dim=512)).to(device)
    reference = copy.deepcopy(model)
    batch = {
        "x": torch.tensor(rng.normal(size=(B, bag, 3, hw, hw)), dtype=torch.float32,
                          device=device),
        "mask": torch.ones((B, bag), dtype=torch.bool, device=device),
        "time": torch.tensor(rng.uniform(1, 100, B), dtype=torch.float32, device=device),
        "event": torch.ones(B, dtype=torch.float32, device=device),
    }
    ref_loss = _step(reference, batch, 0)
    put = parallel.BatchPut(mesh, shard_bag=True)
    local = _local(batch, mesh, put.shard_bag)
    assert local["x"].shape[1] == bag // mesh.mp
    with parallel.activate(put):
        loss = _step(model, local, 0, mesh.dp_group)
        parallel.reduce_gradients(list(model.parameters()),
                                  frozenset(model.resnet.parameters()))
    diff = _compare(model, reference, loss, ref_loss, {}, mesh, "bag-sharded MIL step")
    print(f"subcheck bag_sharded_mil OK (bag {bag} over mp={mesh.mp}; ResNet gradients "
          f"within {diff:.2e} of their scale)", flush=True)


def _write_patch_cohort(root: str, csv_path: str, img: int = 16) -> None:
    """Four slides of 6-9 seeded ``img``-px patches in packed shards
    (``loc.txt`` + ``patches.npy``) and their survival CSV."""
    rng = np.random.default_rng(0)
    wsis = ["A", "B", "C", "D"]
    for i, w in enumerate(wsis):
        d = os.path.join(root, w)
        os.makedirs(d, exist_ok=True)
        n = 6 + i
        with open(os.path.join(d, "loc.txt"), "w") as loc:
            loc.write(f"slide_id {w}\nid x y patch_level patch_size_read patch_size_output\n")
            loc.writelines(f"{j} {j * img} 0 0 {img} {img}\n" for j in range(n))
        np.save(os.path.join(d, "patches.npy"), rng.integers(0, 256, (n, img, img, 3), np.uint8))
    months = rng.uniform(1, 120, len(wsis)).round(4)
    with open(csv_path, "w") as f:
        f.write("case,survival_months,vital_status,wsi_file_name\n")
        f.writelines(f"c{i},{m},1,{w}.svs\n" for i, (w, m) in enumerate(zip(wsis, months)))


def sharded_device_cache(mesh: parallel.Mesh, directory: str) -> None:
    """The mesh-sharded device cache with the bag sharded over ``mp``: each
    rank holds its block of the cohort's rows; every batch of two shuffled
    epochs equals the host loader's placed by ``BatchPut``; a MIL step on
    its first batch is held against the one-process step on the host
    loader's batch."""
    from multimodalbrainsurvival_torch.data import PatchBagDataset
    from multimodalbrainsurvival_torch.data.device_cache import (
        DeviceCachedPatchBags,
        cache_bytes,
    )

    device = mesh.device
    root, csv = os.path.join(directory, "patches"), os.path.join(directory, "cohort.csv")
    if mesh.rank == 0:
        _write_patch_cohort(root, csv)
    mesh.barrier()
    put = parallel.BatchPut(mesh, shard_bag=True)

    def dataset():
        return PatchBagDataset(root, csv, img_size=16, bag_size=2 * mesh.mp,
                               max_patches_total=64)

    host = dataset()
    cached = DeviceCachedPatchBags(dataset(), device, num_threads=1, put=put)
    if cached.nbytes > -(-cache_bytes(host) // mesh.world) + 16 * 16 * 3 * mesh.world:
        raise AssertionError(f"sharded cache: rank {mesh.rank} holds {cached.nbytes} bytes "
                             f"of {cache_bytes(host)}")
    batch_size, first = 2 * mesh.dp, None
    for epoch in range(2):
        host.shuffle()
        cached.shuffle()
        pairs = zip(host.batches(batch_size, shuffle=True, seed=epoch, num_threads=1),
                    cached.batches(batch_size, shuffle=True, seed=epoch))
        for want, got in pairs:
            first = first or (want, got)
            w, g = put(want), put(got)
            for k in ("patch_bag", "bag_mask", "sample_mask", "survival_months"):
                if not torch.equal(torch.as_tensor(w[k]).to(device), g[k]):
                    raise AssertionError(f"sharded cache epoch {epoch}: {k} differs from "
                                         "the host loader's")
    torch.manual_seed(7)
    model = AggregationModel(resnet18(num_classes=None),
                             make_aggregator("attention", dim=512)).to(device)
    reference = copy.deepcopy(model)

    def arrays(batch):
        x = torch.as_tensor(batch["patch_bag"]).to(device).float() / 255
        return {"x": x.permute(0, 1, 4, 2, 3).contiguous(),
                "mask": torch.as_tensor(batch["bag_mask"]).to(device),
                "time": torch.as_tensor(batch["survival_months"]).to(device).float(),
                "event": torch.as_tensor(batch["vital_status"]).to(device).float()}

    ref_loss = _step(reference, arrays(first[0]), 0)
    with parallel.activate(put):
        loss = _step(model, arrays(put(first[1])), 0, mesh.dp_group)
        parallel.reduce_gradients(list(model.parameters()),
                                  frozenset(model.resnet.parameters()))
    diff = _compare(model, reference, loss, ref_loss, {}, mesh, "sharded device cache step")
    print(f"subcheck sharded_device_cache OK ({cached.nbytes} of {cache_bytes(host)} bytes "
          f"on rank {mesh.rank}; ResNet gradients within {diff:.2e} of their scale)",
          flush=True)


def elastic_resume(mesh: parallel.Mesh, directory: str) -> None:
    """An RNA ``train_model`` run preempted over ``(world, 1)`` after 2
    steps, resumed over ``(world / 2, 2)`` (the same ranks, another
    shape); it must end with the weights of the uninterrupted run in one
    process (SGD: no Adam normalization to amplify rounding)."""
    from multimodalbrainsurvival_torch.data import RNATableDataset
    from multimodalbrainsurvival_torch.train import TrainingPreempted, TrainSettings, train_model
    from multimodalbrainsurvival_torch.train.adapters import TableAdapter
    from multimodalbrainsurvival_torch.train.optim import wrap_optimizer

    device, n = mesh.device, 16
    csv = os.path.join(directory, "rna.csv")
    if mesh.rank == 0:
        rng = np.random.default_rng(8)
        months = rng.uniform(1, 120, n).round(4)
        rna = rng.normal(size=(8, n)).astype(np.float32)
        with open(csv, "w") as f:
            f.write("case,survival_months,vital_status,"
                    + ",".join(f"rna_{i}" for i in range(8)) + "\n")
            for j in range(n):
                f.write(f"c{j},{months[j]},1," + ",".join(repr(float(v)) for v in rna[:, j])
                        + "\n")
    mesh.barrier()
    data = {"train": RNATableDataset(csv)}

    def run(put, save_dir, **kw):
        torch.manual_seed(17)
        model = RNAOnlyModel(RNAEncoder(8, (16, 8), dropout=0.5)).to(device)
        optimizer = wrap_optimizer(torch.optim.SGD(model.parameters(), lr=1e-2))
        settings = TrainSettings(num_epochs=2, batch_size=8, save_dir=save_dir, seed=17,
                                 device_put_fn=put, preempt_sync_every=1, **kw)
        train_model(TableAdapter(model=model, device=device), data, optimizer, settings)
        return model

    with tempfile.TemporaryDirectory() as own:
        want = run(None, own).state_dict()
    save_dir = os.path.join(directory, "elastic")
    try:
        run(parallel.BatchPut(mesh), save_dir, preempt_after_steps=2)
        raise AssertionError("elastic resume: the preemption did not happen")
    except TrainingPreempted:
        pass
    other = parallel.make_mesh(max(1, mesh.world // 2), 2 if mesh.world >= 2 else 1,
                               device=device)
    got = run(parallel.batch_device_put(other), save_dir, resume=True).state_dict()
    for k, v in want.items():
        if not torch.allclose(got[k], v, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"elastic resume: {k} differs from the uninterrupted run")
    print(f"subcheck elastic_resume OK (dp={mesh.dp} x mp={mesh.mp} -> "
          f"dp={other.dp} x mp={other.mp})", flush=True)


def worker(device_name: str, directory: str) -> None:
    device = resolve_device(device_name)
    parallel.initialize_from_env(device)
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    mp = 2 if world >= 2 else 1
    mesh = parallel.make_mesh(world // mp, mp, device=device)
    loss, resnet_diff = joint_step(mesh)
    bag_sharded_mil(mesh)
    sharded_device_cache(mesh, directory)
    elastic_resume(parallel.make_mesh(world, 1, device=device), directory)
    if mesh.rank == 0:
        print(f"dryrun_multichip OK: mesh={mesh.shape}, loss={loss:.4f}, devices={world}, "
              "subchecks=[joint_tp_sp_step, bag_sharded_mil, sharded_device_cache, "
              "elastic_resume], "
              f"resnet_grad_rel_diff={resnet_diff:.2e}", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def dryrun_multichip(world: int, device: str = "cuda", timeout: float = 600) -> str:
    """Start the dry run's world (a world of 1 runs in this process) and
    return rank 0's output; raises if a rank fails."""
    if world == 1:
        with tempfile.TemporaryDirectory() as d:
            worker(device, d)
        return ""
    with tempfile.TemporaryDirectory() as d:
        results = launch.run(world, [sys.executable, "-m", MODULE, "--worker",
                                     "--device", device, "--dir", d],
                             os.path.join(d, "logs"), timeout)
    for rank, (code, out) in enumerate(results):
        if code:
            raise RuntimeError(f"dry run rank {rank} exited {code}:\n{out[-4000:]}")
    return results[0][1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=2, help="ranks to start")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--dir", type=str, default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.device, args.dir)
        return
    resolve_device(args.device)
    out = dryrun_multichip(args.world, args.device)
    sys.stdout.write(out)


if __name__ == "__main__":
    main()
