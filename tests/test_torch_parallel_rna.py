"""Data parallelism of the table CLIs (``rna_train``, ``feature_train``) in a
gloo world of 2 processes on the CPU, against the port's world-of-one runs
and, at ``dropout: 0``, against the JAX package on a virtual mesh of the
same shape.

One world runs every job of this module in order (``_torch_parallel_worker
.py``, started once by the ``world`` fixture on a free port): first-step
gradients under ``mesh: {"dp": 2}`` at dropout 0.5 (a run without a
``flag``: rank 0's timestamp is broadcast) and 0, with ``accumulate_steps:
2``, and two preempted runs (SIGTERM to rank 1 alone, the consensus every
1 and every 3 check sites), one of them resumed in the same world.
The world-of-one runs, and the JAX step, are made here in the test
process while the world works.

Tolerances: the loss at ``rtol=1e-5``; gradients at the JAX test's
``rtol=1e-4, atol=1e-5 x`` the largest gradient
(``tests/test_parallel.py::test_dp_training_step_matches_single_device``):
float32 sums in another order (the Cox risk set, the weight gradients
summed over the ranks). They are compared before the optimizer's step:
Adam divides by the gradient's own scale and would hide a factor.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.cli import _common, rna_train
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import RNATableDataset
from multimodalbrainsurvival_torch.models.convert import flax_rna_to_torch
from tests import _torch_parallel_worker as worker
from tests.helpers import make_survival_csv

N_GENES = 16
N_FEATURES = 12
SEED = 1111
LR = 1e-5


def _write_json(path, obj) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def _config(tmp, name, **overrides):
    cfg = {
        "batch_size": 8, "num_workers": 1, "num_epochs": 1,
        "train_csv_path": str(tmp / "train.csv"), "val_csv_path": str(tmp / "val.csv"),
        "test_csv_path": str(tmp / "test.csv"),
        "lr_rna": LR, "lr_mlp": LR, "lr": LR, "weight_decay": 1e-5, "dropout": 0.5,
        "flag": name, "checkpoint_path": str(tmp / "out") + "/",
        "restore_path": str(tmp / "init.pt"), "model_path": "", "log_interval": 1,
    }
    cfg.update(overrides)
    return _write_json(tmp / f"{name}.json", cfg)


def _argv(cfg):
    return ["--config", cfg, "--device", "cpu", "--seed", str(SEED)]


#: the world's jobs: name → (cli, config overrides, sigterm step of rank 1)
JOBS = {
    "rna": ("rna_train", {"mesh": {"dp": 2}, "num_epochs": 2, "flag": ""}, 0),
    "rna_d0": ("rna_train", {"mesh": {"dp": 2}, "dropout": 0.0}, 0),
    "feature": ("feature_train", {"mesh": {"dp": 2}}, 0),
    "accumulate": ("rna_train", {"mesh": {"dp": 2}, "accumulate_steps": 2}, 0),
    "preempt_1": ("rna_train", {"mesh": {"dp": 2}, "num_epochs": 2,
                                "preempt_sync_every": 1}, 2),
    "preempt_3": ("rna_train", {"mesh": {"dp": 2}, "num_epochs": 2,
                                "preempt_sync_every": 3}, 2),
    "resume_3": ("rna_train", {"mesh": {"dp": 2}, "num_epochs": 2,
                               "preempt_sync_every": 3, "resume": True,
                               "flag": "preempt_3"}, 0),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_rna")
    for split, n, seed in (("train", 24, 5), ("val", 12, 6), ("test", 12, 7)):
        make_survival_csv(str(tmp / f"{split}.csv"), [f"{split}{i}" for i in range(n)],
                          n_rna=N_GENES, n_feature=N_FEATURES, seed=seed)
    torch.manual_seed(3)
    torch.save(rna_train.build_rna_model(None, N_GENES).state_dict(), str(tmp / "init.pt"))
    from multimodalbrainsurvival_torch.cli.feature_train import build_feature_model

    torch.manual_seed(4)
    torch.save(build_feature_model(Config({}), N_FEATURES).state_dict(),
               str(tmp / "init_feature.pt"))
    jobs = []
    for name, (cli, overrides, sigterm) in JOBS.items():
        overrides = dict(overrides)
        if cli == "feature_train":
            overrides["restore_path"] = str(tmp / "init_feature.pt")
        cfg = _config(tmp, name, **overrides)
        jobs.append({"cli": cli, "argv": _argv(cfg), "grads": str(tmp / f"{name}.grads.pt"),
                     "sigterm_rank": 1, "sigterm_step": sigterm})
    out = tmp / "codes"
    out.mkdir()

    def references():
        for name, cli, overrides in FIRST_STEP:
            _world_of_one(tmp, name, cli, **overrides)
        _jax_dp_step(tmp)

    results, _ = worker.run_world(2, _write_json(tmp / "jobs.json", jobs), str(out),
                                  str(tmp / "logs"), references)
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{log[-3000:]}"
    codes = [json.loads((out / f"codes{r}.json").read_text()) for r in range(2)]
    yield tmp, dict(zip(JOBS, zip(*codes))), [log for _, log in results]
    # a suite run keeps its temporary files on one disk
    shutil.rmtree(tmp, ignore_errors=True)


_REFERENCES: dict = {}


def _world_of_one(tmp, name, cli="rna_train", **overrides):
    """``name``'s first step in this process, without a mesh (made once)."""
    key = (str(tmp), name)
    if key not in _REFERENCES:
        overrides = {"flag": f"{name}_w1", **overrides}
        if cli == "feature_train":
            overrides["restore_path"] = str(tmp / "init_feature.pt")
        cfg = _config(tmp, f"{name}_w1", **overrides)
        record = {}
        assert worker.run_cli(cli, _argv(cfg), record) == 0
        _REFERENCES[key] = record
    return _REFERENCES[key]


def _assert_grads_close(got: dict, want: dict, floor: float = 0.0):
    """The JAX test's tolerance; ``floor``: a measured rounding floor that
    raises the absolute part where it is larger."""
    scale = max(float(g.abs().max()) for g in want.values())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=max(1e-5 * scale, floor), err_msg=k)


#: the first steps held against the world of one: (name, cli, overrides)
FIRST_STEP = [
    ("rna", "rna_train", {}),
    ("rna_d0", "rna_train", {"dropout": 0.0}),
    ("feature", "feature_train", {}),
    ("accumulate", "rna_train", {"accumulate_steps": 2}),
]


@pytest.mark.parametrize("name,cli,overrides", FIRST_STEP)
def test_first_step_matches_the_world_of_one(world, name, cli, overrides):
    """Loss and gradients of the first step under ``{"dp": 2}`` equal the
    port's one-process run (dropout 0.5: each rank draws its rows of the
    global mask through K2's row offset)."""
    tmp, codes, _ = world
    assert codes[name] == (0, 0)
    got = torch.load(str(tmp / f"{name}.grads.pt"))
    want = _world_of_one(tmp, name, cli, **overrides)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_grads_close(got["grads"], want["grads"])


def test_dp_at_dropout_0_matches_jax_on_the_virtual_mesh(world):
    """At ``dropout: 0`` the port's ``{"dp": 2}`` first step equals the JAX
    package's loss and gradients with the same batch placed on a ``dp=2``
    virtual mesh (``batch_device_put``)."""
    tmp, _, _ = world
    got = torch.load(str(tmp / "rna_d0.grads.pt"))
    loss, want = _jax_dp_step(tmp)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _assert_grads_close(got["grads"], want)


def jax_rna_step(tmp, mesh: dict) -> tuple[float, dict]:
    """The JAX package's loss and gradients (reference layout) of the RNA
    model at ``tmp/init.pt`` without dropout, on the first batch of
    ``tmp/train.csv`` placed on a virtual mesh of ``mesh``'s shape."""
    from multimodalbrainsurvival_tpu.models.convert import torch_rna_to_flax
    from multimodalbrainsurvival_tpu.models.rna import RNAEncoder, RNAOnlyModel
    from multimodalbrainsurvival_tpu.ops.cox import cox_partial_likelihood_loss
    from multimodalbrainsurvival_tpu.parallel import batch_device_put, make_mesh

    batch = next(RNATableDataset(str(tmp / "train.csv")).batches(8, shuffle=True, seed=SEED))
    state = {k: v.numpy() for k, v in torch.load(str(tmp / "init.pt")).items()}
    params = torch_rna_to_flax(state)["params"]
    model = RNAOnlyModel(encoder=RNAEncoder(hidden_dims=(4096, 2048), dropout=0.0))
    arrays = batch_device_put(make_mesh(**mesh))({
        k: jnp.asarray(batch[k]) for k in ("data", "survival_months", "vital_status", "mask")})

    def loss_fn(p, a):
        out = model.apply({"params": p}, a["data"])
        return cox_partial_likelihood_loss(out[:, 0], a["survival_months"],
                                           a["vital_status"], a["mask"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, arrays)
    return float(loss), flax_rna_to_torch(jax.tree.map(np.asarray, grads))


def _jax_dp_step(tmp) -> tuple[float, dict]:
    key = (str(tmp), "jax")
    if key not in _REFERENCES:
        _REFERENCES[key] = jax_rna_step(tmp, {"dp": 2, "mp": 1})
    return _REFERENCES[key]


def _flagless_run(tmp) -> str:
    runs = [d for d in os.listdir(tmp / "out" / "models") if d.startswith("train_")]
    assert len(runs) == 1, runs
    return runs[0]


def test_without_flag_every_rank_writes_under_rank_0s_flag(world):
    tmp, codes, _ = world
    assert codes["rna"] == (0, 0)
    runs = [_flagless_run(tmp)]
    assert sorted(os.listdir(tmp / "out" / "outputs" / runs[0])) == sorted(
        f"{s}_output_{t}.csv" for s in ("train", "val", "test") for t in ("last", "best"))


def _weights(path):
    return torch.load(str(path), weights_only=True)


def test_preemption_of_one_rank_is_agreed_and_resumes_at_world_1(world):
    """SIGTERM reaches rank 1 alone: with the consensus at every check site
    both ranks save once and exit 143; the state resumes in one process
    (another mesh shape) and ends within a few LR steps of the uninterrupted
    two-rank run, ``rna`` (Adam moves a float32-noise gradient by up to its
    LR a step, in a direction the rounding picks)."""
    tmp, codes, _ = world
    assert codes["preempt_1"] == (143, 143)
    save = tmp / "out" / "models" / "preempt_1"
    assert sorted(os.listdir(save)) == ["train_state.pt.preempt"]
    record = {}
    cfg = _config(tmp, "preempt_1", num_epochs=2, resume=True)
    assert worker.run_cli("rna_train", _argv(cfg), record) == 0
    got = _weights(save / "model_last.pt")
    want = _weights(tmp / "out" / "models" / _flagless_run(tmp) / "model_last.pt")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=4 * 6 * LR, err_msg=k)
    assert not (save / "train_state.pt.preempt").exists()


def test_thinned_consensus_and_resume_in_the_world_are_exact(world):
    """``preempt_sync_every: 3``: both ranks stop at one agreed site, exit
    143 and leave one ``.preempt``; resumed in the same world the run ends
    with the uninterrupted two-rank run's weights (``rna``'s), bit for
    bit."""
    tmp, codes, logs = world
    assert codes["preempt_3"] == (143, 143)
    assert codes["resume_3"] == (0, 0)
    assert "a peer rank asked for preemption" in logs[0]
    got = _weights(tmp / "out" / "models" / "preempt_3" / "model_last.pt")
    want = _weights(tmp / "out" / "models" / _flagless_run(tmp) / "model_last.pt")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_mesh_over_another_world_size_raises_with_the_launcher(tmp_path):
    cfg = Config({"mesh": {"dp": 2}})
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node"):
        _common.make_device_put(cfg, torch.device("cpu"), "f")


def test_distributed_without_flag_raises(tmp_path):
    cfg = _write_json(tmp_path / "c.json", {"mesh": {"dp": 1, "distributed": True}})
    args = _common.make_parser("t").parse_args(["--config", cfg])
    with pytest.raises(SystemExit, match="explicit 'flag'"):
        _common.load_config(args)


@pytest.mark.parametrize("key,value", [("cache_patches_on_device", True),
                                       ("quantize", "int8"), ("quantize_trunk", "int8"),
                                       ("fold_bn", True)])
def test_item_7b_keys_raise_under_a_mesh(key, value):
    """The keys whose paths once ran on one device alone run under a mesh
    (``tests/test_torch_parallel_{serving,cache}.py``): a mesh over
    another world size raises as any mesh does, naming the launcher, and a
    mesh of one device places nothing."""
    cfg = Config({"mesh": {"dp": 2}, key: value})
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node"):
        _common.make_device_put(cfg, torch.device("cpu"), "f")
    put, _, _ = _common.make_device_put(Config({"mesh": {"dp": 1}, key: value}),
                                        torch.device("cpu"), "f")
    assert put is None


@pytest.mark.parametrize("cli", ["slide_extractfeatures", "slide_joint_savescore",
                                 "cv_run", "sweep"])
def test_item_7b_entry_points_raise_under_a_mesh(cli, tmp_path):
    """These entry points place their batches over the mesh
    (``tests/test_torch_parallel_{stream,cv}.py``): in a world of one
    process a mesh of 2 raises, naming the launcher."""
    import importlib

    cfg = _write_json(tmp_path / "c.json", {"mesh": {"dp": 2, "mp": 1}})
    argv = ["--config", cfg, "--device", "cpu"]
    if cli in ("cv_run", "sweep"):
        argv += ["--task", "rna"]
    if cli == "sweep":
        argv += ["--grid", '{"lr": [1e-4]}']
    main = importlib.import_module(f"multimodalbrainsurvival_torch.cli.{cli}").main
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node"):
        main(argv)
