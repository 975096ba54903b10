"""One rank of the worlds that ``tests/test_torch_parallel_*.py`` start.

``python tests/_torch_parallel_worker.py jobs.json out_dir`` (under
``multimodalbrainsurvival_torch.parallel.launch``, which sets the rank's
variables) runs the jobs of ``jobs.json`` in order in one process group and
writes ``out_dir/codes<rank>.json``, each job's exit status. A job is:

- ``{"cli": name, "argv": [...], "grads": path, "sigterm_step": k,
  "sigterm_rank": r, "skew_rank": s}``: ``multimodalbrainsurvival_torch.cli.
  <name>.main(argv)``; rank 0 saves the first step's loss and gradients
  (``capture``) to ``grads``; rank ``r`` sends itself SIGTERM before its
  ``k``-th step; rank ``s`` calibrates int8 with doubled abs-maxes
  (``skewed_calibration``), which its results show unless it takes rank
  0's qtree;
- ``{"tp": {...}}``: the tensor-parallel RNA encoder of ``tp_check``;
- ``{"cache": {...}}``: the mesh-sharded device cache of ``cache_check``.

The test process imports ``capture``, ``synced_statistics`` and
``tp_reference`` for its world-of-one runs. After each CLI job rank 0 deletes the run's
``train_state.pt`` and ``model_dict_best.pt`` (``prune``): the tests read
``model_last.pt`` and an emergency ``.preempt`` only, and a suite run keeps
its temporary files on one disk.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import os
import signal
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multimodalbrainsurvival_torch.train import loop  # noqa: E402


@contextlib.contextmanager
def capture(record: dict, sigterm_step: int = 0):
    """Patch the loop's ``train_step``: ``record`` gets the first step's
    global ``loss`` and every parameter's ``grads`` (by name, on the CPU)
    as the optimizer sees them; with ``sigterm_step`` the process sends
    itself SIGTERM before that step (1-based)."""
    original = loop.train_step
    calls = [0]

    def train_step(adapter, optimizer, loss_fn, arrays, settings, generator):
        calls[0] += 1
        if calls[0] == sigterm_step:
            os.kill(os.getpid(), signal.SIGTERM)
        if "grads" in record:
            return original(adapter, optimizer, loss_fn, arrays, settings, generator)
        step = optimizer.step

        def take():
            record["grads"] = {n: p.grad.detach().cpu().clone()
                               for n, p in adapter.model.named_parameters()
                               if p.grad is not None}
            step()

        optimizer.step = take
        try:
            loss = original(adapter, optimizer, loss_fn, arrays, settings, generator)
        finally:
            del optimizer.step
        record["loss"] = float(loss)
        return loss

    loop.train_step = train_step
    try:
        yield record
    finally:
        loop.train_step = original


@contextlib.contextmanager
def skewed_calibration(on: bool):
    """With ``on``, int8 quantization (``models.quantize.quantize_resnet``)
    takes every site's abs-max doubled."""
    from multimodalbrainsurvival_torch.models import quantize

    original = quantize.quantize_resnet
    if on:
        quantize.quantize_resnet = lambda state, amax, **kw: original(
            state, {k: 2 * v for k, v in amax.items()}, **kw)
    try:
        yield
    finally:
        quantize.quantize_resnet = original


@contextlib.contextmanager
def synced_statistics():
    """Train-mode BatchNorm of a world of one in the synced arithmetic
    (``SyncedBatchNorm2d.synced_forward`` over this process alone), in
    place of ``nn.BatchNorm2d``'s."""
    from multimodalbrainsurvival_torch.models.resnet import SyncedBatchNorm2d

    original = SyncedBatchNorm2d.forward

    def forward(self, x):
        return self.synced_forward(x, None) if self.training else original(self, x)

    SyncedBatchNorm2d.forward = forward
    try:
        yield
    finally:
        SyncedBatchNorm2d.forward = original


def start_world(world: int, jobs_path: str, out_dir: str, log_dir: str) -> list:
    """This worker over ``world`` ranks (``parallel.launch.start``), four
    threads in all: the suite runs beside other test processes."""
    from multimodalbrainsurvival_torch.parallel import launch

    return launch.start(world, [sys.executable, os.path.abspath(__file__), jobs_path,
                                out_dir], log_dir,
                        env={**os.environ, "OMP_NUM_THREADS": str(max(1, 4 // world))})


def finish_world(ranks: list, timeout: float = 240) -> list[tuple[int, str]]:
    """Each rank's ``(exit status, output)`` once all have ended."""
    from multimodalbrainsurvival_torch.parallel import launch

    codes = launch.wait(ranks, timeout)
    return [(c, r.output()) for c, r in zip(codes, ranks)]


def run_world(world: int, jobs_path: str, out_dir: str, log_dir: str,
              references=None, timeout: float = 240):
    """``start_world``, then ``references()`` in this process while the
    world works (the world-of-one and JAX runs the tests compare with),
    then ``finish_world`` → (each rank's ``(exit status, output)``, what
    ``references`` returned)."""
    ranks = start_world(world, jobs_path, out_dir, log_dir)
    try:
        refs = references() if references is not None else None
    finally:
        results = finish_world(ranks, timeout)
    return results, refs


def prune(argv: list[str]) -> None:
    """Delete the ``train_state.pt`` and ``model_dict_best.pt`` files of the
    run that ``argv``'s config names (``<checkpoint_path>/models/<flag>``,
    or ``train_*`` without a flag), and no other run's: the runs of a
    module share a ``checkpoint_path`` and run at once."""
    with open(argv[argv.index("--config") + 1]) as f:
        cfg = json.load(f)
    models = os.path.join(cfg.get("checkpoint_path", ""), "models")
    if not cfg.get("checkpoint_path") or not os.path.isdir(models):
        return
    flag = cfg.get("flag", "")
    for run in os.listdir(models):
        if run == flag or (not flag and run.startswith("train_")):
            for name in ("train_state.pt", "model_dict_best.pt"):
                path = os.path.join(models, run, name)
                if os.path.exists(path):
                    os.remove(path)


def run_cli(name: str, argv: list[str], record: dict | None = None,
            sigterm_step: int = 0, rank: int = 0) -> int:
    """``cli.<name>.main(argv)`` → its exit status; rank 0 then prunes its
    checkpoints."""
    module = importlib.import_module(f"multimodalbrainsurvival_torch.cli.{name}")
    code = 0
    with capture({} if record is None else record, sigterm_step):
        try:
            module.main(argv)
        except SystemExit as e:
            code = int(e.code or 0)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    if rank == 0:
        prune(argv)
    return code


def tp_model(spec: dict):
    """The seeded RNA model of a tensor-parallel check and its global batch."""
    from multimodalbrainsurvival_torch.models import RNAEncoder, RNAOnlyModel

    torch.manual_seed(spec["seed"])
    model = RNAOnlyModel(RNAEncoder(spec["in"], spec["hidden"], dropout=spec["p"]))
    rng = np.random.default_rng(spec["seed"])
    x = torch.tensor(rng.normal(size=(spec["batch"], spec["in"])), dtype=torch.float32)
    t = torch.tensor(rng.uniform(1, 100, spec["batch"]), dtype=torch.float32)
    e = torch.tensor(rng.integers(0, 2, spec["batch"]), dtype=torch.float32)
    return model, x, t, e


def tp_reference(spec: dict) -> dict:
    """The unsharded model's train-mode output, loss and gradients on the
    global batch, and its eval-mode output."""
    from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss

    model, x, t, e = tp_model(spec)
    model.train()
    out = model.final_mlp(model.rna_mlp(x, seed=spec["dropout_seed"]))
    loss = cox_partial_likelihood_loss(out[:, 0], t, e)
    loss.backward()
    model.eval()
    with torch.no_grad():
        eval_out = model(x)
    return {"out": out.detach(), "loss": float(loss), "eval_out": eval_out,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": copy.deepcopy(model.state_dict())}


def tp_check(spec: dict) -> dict:
    """The model of ``tp_model`` with its encoder sharded over a ``(dp,
    mp)`` mesh (``parallel/sharding.py``): one Cox step on this rank's rows
    → the gathered outputs, loss and gradients (reference layout)."""
    from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss
    from multimodalbrainsurvival_torch.parallel import mesh as parallel
    from multimodalbrainsurvival_torch.parallel.sharding import (
        gathered_state_dict,
        joint_param_shardings,
        shard_model,
    )

    mesh = parallel.make_mesh(spec["dp"], spec["mp"])
    model, x, t, e = tp_model(spec)
    plan = joint_param_shardings(model)
    shard_model(model, mesh)
    b = x.shape[0] // mesh.dp
    rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
    with parallel.activate(parallel.BatchPut(mesh)):
        model.train()
        out = model.final_mlp(model.rna_mlp(x[rows], seed=spec["dropout_seed"]))
        loss = cox_partial_likelihood_loss(out[:, 0], t[rows], e[rows], group=mesh.dp_group)
        loss.backward()
        parallel.reduce_gradients(list(model.parameters()))
        out = parallel.gather_rows(out.detach())
        model.eval()
        with torch.no_grad():
            eval_out = parallel.gather_rows(model(x[rows]))
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad
        if plan[n] is not None:
            g = parallel.all_gather(g, mesh.mp_group, plan[n])
        grads[n] = g
    return {"out": out, "loss": float(loss), "eval_out": eval_out, "grads": grads,
            "state": gathered_state_dict(model)}


def cache_check(spec: dict) -> dict:
    """The mesh-sharded device cache over ``spec["mesh"]`` on the patch
    cohort of ``spec`` (``root``, ``csv``, ``bag``): over two epochs, the
    second after ``shuffle()``, every batch placed by ``BatchPut`` against the host
    loader's (arrays, lists and ``host_*`` mirrors equal), the first
    epoch's ``patch_bag`` parts saved (``spec["out"]`` + rank), the rows
    this rank holds, the budget (a cohort over one rank's budget held by
    the world) and the refusals (``bag_size`` over ``mp`` under
    ``shard_bag``, ``batch_size`` over ``dp``)."""
    from multimodalbrainsurvival_torch.data import PatchBagDataset
    from multimodalbrainsurvival_torch.data.device_cache import (
        DeviceCachedPatchBags,
        cache_bytes,
        maybe_cache_on_device,
    )
    from multimodalbrainsurvival_torch.parallel import mesh as parallel

    m = spec["mesh"]
    mesh = parallel.make_mesh(m.get("dp"), m.get("mp", 1))
    put = parallel.BatchPut(mesh, shard_bag=m.get("shard_bag", False))

    def dataset(bag=spec["bag"]):
        return PatchBagDataset(spec["root"], spec["csv"], img_size=spec["img"], bag_size=bag,
                               max_patches_total=100)

    host, base = dataset(), dataset()
    budget = -(-cache_bytes(base) // mesh.world)  # one rank's share: too small alone
    cached = maybe_cache_on_device(base, True, device=torch.device("cpu"), max_bytes=budget,
                                   num_threads=1, put=put)
    alone = maybe_cache_on_device(dataset(), True, device=torch.device("cpu"),
                                  max_bytes=budget)
    report = {"cached": isinstance(cached, DeviceCachedPatchBags),
              "cached_alone": isinstance(alone, DeviceCachedPatchBags),
              "nbytes": cached.nbytes, "cohort_bytes": cache_bytes(base), "mismatches": [],
              "batches": 0}
    parts = []
    keys = ("patch_bag", "bag_mask", "sample_mask", "survival_months", "vital_status")
    for epoch in range(2):
        if epoch:
            host.shuffle()
            cached.shuffle()
        for want, got in zip(host.batches(spec["batch"], shuffle=True, seed=epoch,
                                          num_threads=1),
                             cached.batches(spec["batch"], shuffle=True, seed=epoch)):
            report["batches"] += 1
            w, g = put(want), put(got)
            for k in keys:
                if not torch.equal(torch.as_tensor(w[k]), g[k]):
                    report["mismatches"].append((epoch, k))
            for k in ("WSI", "case"):
                if list(want[k]) != list(got[k]):
                    report["mismatches"].append((epoch, k))
            for k in ("sample_mask", "survival_months", "vital_status"):
                if not np.array_equal(np.asarray(want[k]), got["host_" + k]):
                    report["mismatches"].append((epoch, "host_" + k))
            if epoch == 0:
                parts.append(g["patch_bag"].numpy())
    np.savez(f"{spec['out']}{mesh.rank}.npz", *parts)
    for what, make in (("bag", lambda: DeviceCachedPatchBags(
                            dataset(bag=3), torch.device("cpu"), num_threads=1, put=put)),
                       ("batch", lambda: next(cached.batches(3)))):
        try:
            make()
            report[f"{what}_error"] = None
        except ValueError as e:
            report[f"{what}_error"] = str(e)
    return report


def main() -> None:
    from multimodalbrainsurvival_torch.parallel import mesh as parallel

    jobs_path, out_dir = sys.argv[1], sys.argv[2]
    with open(jobs_path) as f:
        jobs = json.load(f)
    parallel.initialize_from_env(torch.device("cpu"))
    rank = torch.distributed.get_rank()
    codes = []
    for job in jobs:
        if "tp" in job:
            result = tp_check(job["tp"])
            if rank == 0:
                torch.save(result, job["tp"]["out"])
            codes.append(0)
            continue
        if "cache" in job:
            with open(f"{job['cache']['out']}{rank}.json", "w") as f:
                json.dump(cache_check(job["cache"]), f)
            codes.append(0)
            continue
        record: dict = {}
        sigterm = job.get("sigterm_step", 0) if rank == job.get("sigterm_rank", -1) else 0
        with skewed_calibration(rank == job.get("skew_rank", -1)):
            codes.append(run_cli(job["cli"], job["argv"], record, sigterm, rank))
        if rank == 0 and job.get("grads") and "grads" in record:
            torch.save(record, job["grads"])
    with open(os.path.join(out_dir, f"codes{rank}.json"), "w") as f:
        json.dump(codes, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
