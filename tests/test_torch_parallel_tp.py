"""The port's mesh, batch placement, tensor-parallel plan, K2's mask
offsets and the multichip dry run, on the CPU.

- ``Mesh`` coordinates and ``BatchPut``'s slices against the JAX
  ``make_mesh`` / ``batch_device_put`` addressable shards on the virtual
  8-device mesh, for (2, 1), (1, 2) and (2, 2), with and without
  ``shard_bag``;
- ``joint_param_shardings`` against the JAX rule's specs at depths 2 and 3;
- the plain K2a / K2b with ``(row0, col0)`` against slices of the whole
  mask, and ``DropoutMatmul``'s gradients under the data- and
  tensor-parallel splits against the unsplit call's;
- the RNA encoder sharded by ``parallel/sharding.py`` in gloo worlds of 2
  (``dp=1, mp=2``) and 4 (``dp=2, mp=2``) at depths 2 and 3: output, loss
  and gradients at dropout 0.5 against the unsharded encoder, and at
  dropout 0 the eval output against the JAX forward under
  ``joint_param_shardings`` on the virtual mesh of the same shape (JAX
  ``test_tp_sharded_rna_forward_matches_replicated``'s tolerance,
  ``rtol=1e-5, atol=1e-6``);
- ``parallel/dryrun.py`` at worlds 2 and 4.

The four worlds (the TP checks' 2 and 4, the dry run's 2 and 4) run at
once, and this process makes the unsharded and JAX references meanwhile.
"""

import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.kernels import dropout_matmul as k2
from multimodalbrainsurvival_torch.models import (
    BagHistopathologyRNAModel,
    RNAEncoder,
    RNAOnlyModel,
)
from multimodalbrainsurvival_torch.models.resnet import resnet18
from multimodalbrainsurvival_torch.parallel.dryrun import dryrun_multichip
from multimodalbrainsurvival_torch.parallel.mesh import BatchPut, Mesh
from multimodalbrainsurvival_torch.parallel.sharding import joint_param_shardings
from tests import _torch_parallel_worker as worker
from tests.test_torch_parallel_rna import _assert_grads_close, _write_json

SHAPES = [(2, 1), (1, 2), (2, 2)]


def _batch():
    rng = np.random.default_rng(0)
    return {
        "patch_bag": rng.integers(0, 255, (8, 4, 2, 2, 3), dtype=np.uint8),
        "bag_mask": rng.random((8, 4)) < 0.8,
        "sample_mask": np.arange(8) < 7,
        "survival_months": rng.uniform(1, 100, 8).astype(np.float32),
        "vital_status": rng.integers(0, 2, 8).astype(np.float32),
        "case": [f"c{i}" for i in range(8)],
    }


@pytest.mark.parametrize("shard_bag", [False, True])
@pytest.mark.parametrize("dp,mp", SHAPES)
def test_rank_slices_are_the_jax_addressable_shards(dp, mp, shard_bag):
    """Rank ``r`` sits at ``(r // mp, r % mp)`` of the JAX mesh and keeps
    the rows (and patches) that the JAX device there holds."""
    from multimodalbrainsurvival_tpu.parallel import batch_device_put, make_mesh

    jmesh = make_mesh(dp=dp, mp=mp)
    batch = _batch()
    arrays = batch_device_put(jmesh, shard_bag=shard_bag)(
        {k: v for k, v in batch.items() if k != "case"})
    for r in range(dp * mp):
        mesh = Mesh(dp, mp, r, torch.device("cpu"), None)
        local = BatchPut(mesh, shard_bag)(batch)
        device = jmesh.devices[mesh.dp_rank, mesh.mp_rank]
        for k, v in arrays.items():
            shard = next(s for s in v.addressable_shards if s.device == device)
            np.testing.assert_array_equal(local[k], np.asarray(shard.data), err_msg=k)
        assert local["case"] == batch["case"]


@pytest.mark.parametrize("depth", [2, 3])
def test_tp_plan_is_the_jax_rule(depth):
    """Even Linears column-parallel (``P(None, 'mp')`` = the weight's dim 0),
    odd row-parallel (``P('mp', None)`` = dim 1), the rest replicated, in
    the RNA model and in the joint model."""
    from multimodalbrainsurvival_tpu.models.rna import RNAEncoder as JaxEncoder
    from multimodalbrainsurvival_tpu.models.rna import RNAOnlyModel as JaxModel
    from multimodalbrainsurvival_tpu.parallel import joint_param_shardings as jax_rule
    from multimodalbrainsurvival_tpu.parallel import make_mesh

    hidden = (32, 16, 8)[:depth]
    jmodel = JaxModel(encoder=JaxEncoder(hidden_dims=hidden))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 12)))["params"]
    specs = jax_rule(params, make_mesh(dp=4, mp=2))
    want = {}
    for i in range(depth):
        spec = specs["encoder"][f"dense_{i}"]["kernel"].spec
        # the flax kernel is (in, out): its 'mp' axis is the torch weight's other dim
        want[f"rna_mlp.{3 * i + 1}.weight"] = {(None, "mp"): 0, ("mp", None): 1}[tuple(spec)]
        assert specs["encoder"][f"dense_{i}"]["bias"].spec == jax.sharding.PartitionSpec()
    assert specs["final"]["kernel"].spec == jax.sharding.PartitionSpec()
    for model in (RNAOnlyModel(RNAEncoder(12, hidden)),
                  BagHistopathologyRNAModel(resnet18(num_classes=None), RNAEncoder(12, hidden))):
        plan = joint_param_shardings(model)
        for name, dim in plan.items():
            if name.endswith(".weight") and name.startswith("rna_mlp."):
                assert dim == want[name], name
            elif name.startswith("rna_mlp.") and name.endswith(".bias"):
                # the port adds a column-parallel layer's bias on its columns
                assert dim == (0 if want[name[:-4] + "weight"] == 0 else None), name
            else:
                assert dim is None, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_masks_are_slices_of_the_whole_mask(dtype):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(12, 40)), dtype=torch.float32).to(dtype)
    whole = k2.keep_mask(30, 100, 77, 0.5)
    np.testing.assert_array_equal(k2.keep_mask(12, 40, 77, 0.5, row0=9, col0=50),
                                  whole[9:21, 50:90])
    full = k2.seeded_dropout_plain(torch.zeros(30, 100, dtype=dtype).copy_(
        torch.ones(30, 100)), 77, 0.5)
    got = k2.seeded_dropout(torch.ones(12, 40, dtype=dtype), 77, 0.5, row0=9, col0=50)
    assert torch.equal(got, full[9:21, 50:90])
    a, b = k2.seeded_dropout_pair(x, 2 * x, 77, 0.5, 9, 50)
    assert torch.equal(a, k2.seeded_dropout(x, 77, 0.5, 9, 50))
    assert torch.equal(b, k2.seeded_dropout(2 * x, 77, 0.5, 9, 50))
    w = torch.tensor(rng.normal(size=(6, 40)), dtype=torch.float32).to(dtype)
    big = torch.zeros(30, 100, dtype=dtype)
    big[9:21, 50:90] = x
    wbig = torch.zeros(6, 100, dtype=dtype)
    wbig[:, 50:90] = w
    torch.testing.assert_close(k2.dropout_matmul(x, w, 77, 0.5, 9, 50),
                               k2.dropout_matmul(big, wbig, 77, 0.5)[9:21],
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="alias"):
        k2.seeded_dropout(x, 1, 0.5, col0=k2.MAX_K - 39)


def test_dropout_matmul_splits_match_the_whole_call():
    """The dp split (row halves at ``row0``) and the TP split of a
    row-parallel layer (column halves of x and W at ``col0``, the partial
    products summed) give the unsplit call's output and gradients."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(8, 24)), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.normal(size=(5, 24)), dtype=torch.float32, requires_grad=True)
    g = torch.tensor(rng.normal(size=(8, 5)), dtype=torch.float32)
    k2.DropoutMatmul.apply(x, w, 5, 0.5).backward(g)
    want = (x.grad.clone(), w.grad.clone())
    xs = [x.detach()[r * 4:(r + 1) * 4].clone().requires_grad_() for r in range(2)]
    ws = [w.detach().clone().requires_grad_() for _ in range(2)]
    for r in range(2):
        k2.DropoutMatmul.apply(xs[r], ws[r], 5, 0.5, 4 * r).backward(g[r * 4:(r + 1) * 4])
    torch.testing.assert_close(torch.cat([xs[0].grad, xs[1].grad]), want[0])
    torch.testing.assert_close(ws[0].grad + ws[1].grad, want[1])
    xc = [x.detach()[:, m * 12:(m + 1) * 12].clone().requires_grad_() for m in range(2)]
    wc = [w.detach()[:, m * 12:(m + 1) * 12].clone().requires_grad_() for m in range(2)]
    out = sum(k2.DropoutMatmul.apply(xc[m], wc[m], 5, 0.5, 0, 12 * m) for m in range(2))
    out.backward(g)
    torch.testing.assert_close(torch.cat([xc[0].grad, xc[1].grad], 1), want[0])
    torch.testing.assert_close(torch.cat([wc[0].grad, wc[1].grad], 1), want[1])


#: tensor-parallel checks: (world, dp, mp, hidden, dropout)
TP = [(2, 1, 2, (32, 16), 0.5), (2, 1, 2, (32, 16, 8), 0.5), (2, 1, 2, (32, 16, 8), 0.0),
      (4, 2, 2, (32, 16), 0.5), (4, 2, 2, (32, 16, 8), 0.5), (4, 2, 2, (32, 16), 0.0)]


def _spec(tmp, i, world, dp, mp, hidden, p):
    return {"dp": dp, "mp": mp, "in": 12, "hidden": list(hidden), "batch": 8, "p": p,
            "seed": 30 + i, "dropout_seed": 900 + i, "out": str(tmp / f"tp{i}.pt")}


_REFERENCES: dict = {}


def _tp_reference(tmp, i) -> dict:
    key = (str(tmp), i)
    if key not in _REFERENCES:
        _REFERENCES[key] = worker.tp_reference(_spec(tmp, i, *TP[i]))
    return _REFERENCES[key]


@pytest.fixture(scope="module")
def tp_worlds(tmp_path_factory):
    """The TP checks' worlds of 2 and 4 and the dry runs at worlds 2 and 4,
    all at once, with this process's references made meanwhile → (the
    directory, {world: the dry run's future})."""
    tmp = tmp_path_factory.mktemp("parallel_tp")
    # one thread a dry-run rank: the suite runs beside other test processes
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(2) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        dryruns = {world: pool.submit(dryrun_multichip, world, "cpu", 180) for world in (2, 4)}
        worlds = {}
        try:
            for world in (2, 4):
                jobs = [{"tp": _spec(tmp, i, *case)} for i, case in enumerate(TP)
                        if case[0] == world]
                out = tmp / f"codes{world}"
                out.mkdir()
                worlds[world] = worker.start_world(
                    world, _write_json(tmp / f"jobs{world}.json", jobs), str(out),
                    str(tmp / f"logs{world}"))
            for i, case in enumerate(TP):
                _tp_reference(tmp, i)
                if case[4] == 0.0:
                    _jax_forward(tmp, i)
        finally:
            results = {}
            for world, ranks in worlds.items():
                try:
                    results[world] = worker.finish_world(ranks, 180)
                except TimeoutError as e:
                    results[world] = [(-1, str(e))]
        for world, res in results.items():
            for rank, (code, log) in enumerate(res):
                assert code == 0, f"world {world} rank {rank} exited {code}:\n{log[-3000:]}"
        yield tmp, dryruns
    # a suite run keeps its temporary files on one disk
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("i", range(len(TP)))
def test_tp_encoder_matches_the_unsharded_encoder(tp_worlds, i):
    tmp, _ = tp_worlds
    spec = _spec(tmp, i, *TP[i])
    got = torch.load(spec["out"])
    want = _tp_reference(tmp, i)
    torch.testing.assert_close(got["out"], want["out"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_grads_close(got["grads"], want["grads"])
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k


def _jax_forward(tmp, i) -> np.ndarray:
    """The JAX forward of TP check ``i``'s model under
    ``joint_param_shardings`` on the virtual mesh of its shape (made
    once)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodalbrainsurvival_tpu.models.rna import RNAEncoder as JaxEncoder
    from multimodalbrainsurvival_tpu.models.rna import RNAOnlyModel as JaxModel
    from multimodalbrainsurvival_tpu.parallel import joint_param_shardings as jax_rule
    from multimodalbrainsurvival_tpu.parallel import make_mesh

    key = (str(tmp), i, "jax")
    if key in _REFERENCES:
        return _REFERENCES[key]
    world, dp, mp, hidden, _ = TP[i]
    model, x, _, _ = worker.tp_model(_spec(tmp, i, *TP[i]))
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    linears = [k[:-len(".weight")] for k in state if k.startswith("rna_mlp.") and
               k.endswith(".weight")]
    dense = {f"dense_{j}": {"kernel": state[f"{n}.weight"].T, "bias": state[f"{n}.bias"]}
             for j, n in enumerate(linears)}
    params = {"encoder": dense, "final": {"kernel": state["final_mlp.0.weight"].T,
                                          "bias": state["final_mlp.0.bias"]}}
    jmesh = make_mesh(dp=dp, mp=mp)
    jmodel = JaxModel(encoder=JaxEncoder(hidden_dims=tuple(hidden), dropout=0.0))
    sharded = jax.device_put(params, jax_rule(params, jmesh))
    xs = jax.device_put(jnp.asarray(x.numpy()), NamedSharding(jmesh, P("dp")))
    _REFERENCES[key] = np.asarray(jax.jit(jmodel.apply)({"params": sharded}, xs))
    return _REFERENCES[key]


@pytest.mark.parametrize("i", [i for i, case in enumerate(TP) if case[4] == 0.0])
def test_tp_forward_matches_jax_on_the_virtual_mesh(tp_worlds, i):
    tmp, _ = tp_worlds
    got = torch.load(_spec(tmp, i, *TP[i])["out"])
    np.testing.assert_allclose(got["eval_out"].numpy(), _jax_forward(tmp, i), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip(tp_worlds, world):
    out = tp_worlds[1][world].result()
    assert f"dryrun_multichip OK: mesh={{'dp': {world // 2}, 'mp': 2}}" in out
    assert "subcheck bag_sharded_mil OK" in out and "subcheck elastic_resume OK" in out
