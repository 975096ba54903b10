"""The port's ``histo_train`` against the JAX CLI on one cohort and one set
of initial weights, on the CPU (``--device cpu``).

The cohort mixes PNG patch directories and packed shards, pads the last
train batch and gives one case two slides (as ``tests/test_torch_histo_cli
.py``). Both stacks start from one seeded ``.pt``; the JAX side reads it
through ``torch_mil_to_flax`` + ``Checkpointer().save``. The runs are
ResNet-18 + attention in float32 at 32 px, ``augment: false`` (torch's
random stream cannot match ``jax.random``; the jitter's arithmetic is held
to the JAX package in ``tests/test_torch_augment.py``), 2 epochs, with
``n_layers_to_train`` 2 (layer4 and the head train, the rest frozen with
their BatchNorm statistics still updating) and 6 (the whole network but
``bn1``). Both stacks re-permute the slides' patches each epoch from the
same numpy stream, so their batches are the same.

The LR is 1e-5, for the reason ``tests/test_torch_rna_cli.py`` gives: optax
takes Adam's bias corrections in float32 and torch in float64, and the Cox
loss is blind to a shift of the scores, so an element whose gradient is
float32 noise steps by a few percent of the LR in a direction the rounding
picks. Losses and frames are held at ``rtol=1e-4, atol=1e-5``. The final
weights: all but 0.1% (or one) of each tensor's elements within 2e-5, and
every element within 2·LR·steps = 2e-4, the most an element can part by
when its gradient is noise each step (a few dozen of layer4's 1.2 M
weights part by up to 8.1e-5, depending on the thread count's summation
order). The BatchNorm running statistics of the frozen stages at
``rtol=1e-4, atol=1e-5``; those of the trained stages follow those parted
weights, and are held at ``rtol=2e-3, atol=2e-3``, the band the JAX
package's own cross-stack test gives them for that reason
(``tests/test_golden_crossstack.py``; measured up to 1.1e-3 at n = 2).

The tests of this file and ``tests/test_torch_train_parts.py`` run torch on
2 threads: at these sizes each op's work is smaller than the cost of
waking 8 threads on a shared host (a ResNet-18 forward of 6 patches took
1-2 s on 8 threads and 0.03 s on one).
"""

import contextlib
import io
import json
import re

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import histo_savescore, histo_train
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.kernels import attention_pool as k1
from tests.helpers import make_patch_dir, make_survival_csv
from tests.test_torch_histo_cli import _pack, _random_state

IMG = 32
WSIS = [f"T{i}" for i in range(5)]
SPLITS = ("train", "val", "test")
LADDERS = (2, 6)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("histo_train_cohort")
    root = str(tmp / "patches")
    for i, w in enumerate(WSIS):
        make_patch_dir(root, w, 6 + i % 2, img_size=IMG, seed=40 + i)
    for w in WSIS[3:]:
        _pack(root, w)
    splits = {"train": ([0, 1, 2, 3, 4], ["c0", "c1", "c2", "c3", "c3"]),
              "val": ([0, 1, 2], ["c0", "c1", "c2"]),
              "test": ([2, 3, 4], ["c2", "c3", "c4"])}
    for split, (idx, cases) in splits.items():
        make_survival_csv(str(tmp / f"{split}.csv"), cases,
                          wsi_names=[f"{WSIS[i]}.svs" for i in idx],
                          seed=3 + len(split))
    return tmp


def _config(cohort, out, **overrides):
    cfg = {
        "model_name": "resnet18", "num_classes": 1, "batch_size": 3,
        "data_path": str(cohort / "patches"),
        "train_csv_path": str(cohort / "train.csv"),
        "val_csv_path": str(cohort / "val.csv"),
        "test_csv_path": str(cohort / "test.csv"),
        "num_workers": 2, "img_size": IMG, "num_epochs": 2,
        "train_bag_size": 2, "val_bag_size": 2,
        "max_patch_per_wsi_train": 6, "max_patch_per_wsi_val": 4,
        "aggregator": "attention", "aggregator_hdim": 512,
        "task": "survival_prediction", "flag": "histo_model",
        "lr": 1e-5, "weight_decay": 1e-4, "augment": False,
        "n_layers_to_train": 2, "log_interval": 2,
        "checkpoint_path": str(out) + "/", "restore_path": "", "model_path": "",
    }
    cfg.update(overrides)
    return cfg


def _write(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _losses(log, tag):
    return [float(v) for v in re.findall(rf"^{tag} Loss: (\S+)$", log, re.M)]


def _best_epoch(log):
    return int(re.search(r"LOADING BEST MODEL, best epoch = (-?\d+)", log).group(1))


def _init_pt(cohort, tmp):
    pt = tmp / "init.pt"
    state = _random_state(build_mil_model(Config(_config(cohort, tmp))), seed=17)
    # a non-zero attention vector, so the softmax over the bag is not uniform
    state["aggregator.vector"] = torch.tensor(
        np.random.default_rng(3).normal(0.0, 0.2, 512), dtype=torch.float32)
    torch.save(state, str(pt))
    return pt


@pytest.fixture(scope="module", params=LADDERS, ids=[f"n{n}" for n in LADDERS])
def runs(request, cohort, tmp_path_factory):
    """histo_train through both stacks' CLI mains (``--log 1``), then the
    port's ``histo_savescore`` on its ``model_last.pt``."""
    from multimodalbrainsurvival_tpu.cli import histo_train as jax_train
    from multimodalbrainsurvival_tpu.models.convert import (
        load_torch_state_dict,
        torch_mil_to_flax,
    )
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    tmp = tmp_path_factory.mktemp(f"histo_train_n{request.param}")
    pt = _init_pt(cohort, tmp)
    flax_init = str(tmp / "init_flax")
    Checkpointer().save(
        flax_init,
        jax.tree.map(np.asarray, torch_mil_to_flax(load_torch_state_dict(str(pt)))),
        block=True)
    result = {"n": request.param, "init": pt}
    for name, main, restore, extra in (
        ("jax", jax_train.main, flax_init, []),
        ("torch", histo_train.main, str(pt), ["--device", "cpu"]),
    ):
        out = tmp / name
        cfg = _config(cohort, out, restore_path=restore,
                      n_layers_to_train=request.param)
        k1.attention_pool_backward.calls = 0
        log = _run(main, ["--config", _write(tmp / f"{name}.json", cfg),
                          "--log", "1"] + extra)
        result[name] = (out, log)
    result["backward_calls"] = k1.attention_pool_backward.calls
    from multimodalbrainsurvival_tpu.cli import histo_savescore as jax_savescore

    for name, main, model, extra in (
        ("jax", jax_savescore.main, "model_last", []),
        ("torch", histo_savescore.main, "model_last.pt", ["--device", "cpu"]),
    ):
        serve = dict(_config(cohort, tmp / name),
                     model_path=str(tmp / name / "models/histo_model" / model),
                     output_path=str(tmp / name / "serve"))
        _run(main, ["--config", _write(tmp / f"{name}_serve.json", serve)] + extra)
    return result


@pytest.mark.parametrize("tag", ["EPOCH", "TRAIN", "VAL"])
def test_epoch_losses_match_jax(runs, tag):
    want, got = _losses(runs["jax"][1], tag), _losses(runs["torch"][1], tag)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tag", ["last", "best"])
@pytest.mark.parametrize("split", SPLITS)
def test_train_frames_match_jax(runs, split, tag):
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    name = f"outputs/histo_model/{split}_output_{tag}.csv"
    want, got = pd.read_csv(jax_out / name), pd.read_csv(torch_out / name)
    assert list(got.columns) == list(want.columns)
    assert list(got["id"]) == list(want["id"])
    for col in ("survival_months", "vital_status"):
        np.testing.assert_array_equal(got[col], want[col])
    assert np.isfinite(got["score"]).all()
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4, atol=1e-5)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_best_epoch_and_last_weights_match_jax(runs):
    """The best epoch, every parameter of ``model_last`` and every BatchNorm
    running statistic, trained and frozen stages alike; the frozen
    parameters are the initial ones exactly."""
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    (jax_out, jax_log), (torch_out, torch_log) = runs["jax"], runs["torch"]
    assert _best_epoch(torch_log) == _best_epoch(jax_log) >= 1
    save_dir = torch_out / "models/histo_model"
    assert {p.name for p in save_dir.iterdir()} >= {
        "model_last.pt", "model_dict_best.pt", "train_state.pt"}
    last = torch.load(save_dir / "model_last.pt", weights_only=True)
    ours = torch_mil_to_flax({k: v.numpy() for k, v in last.items()})
    theirs = Checkpointer().restore(str(jax_out / "models/histo_model/model_last"),
                                    jax.tree.map(np.asarray, ours))
    want = dict(_flat(theirs["params"]))
    for key, got in _flat(ours["params"]):
        np.testing.assert_allclose(got, want[key], rtol=0, atol=2 * 1e-5 * 10,
                                   err_msg=key)
        assert np.sum(np.abs(got - want[key]) > 2e-5) <= max(1, 1e-3 * got.size), key
    trained = ("fc.", "aggregator.", "resnet.layer4.") if runs["n"] == 2 else None
    want = dict(_flat(theirs["batch_stats"]))
    for key, got in _flat(ours["batch_stats"]):
        tol = 1e-4, 1e-5
        if trained is None or key.startswith("resnet/layer4"):
            tol = 2e-3, 2e-3
        np.testing.assert_allclose(got, want[key], rtol=tol[0], atol=tol[1], err_msg=key)
    start = torch.load(runs["init"], weights_only=True)
    for k, v in start.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        frozen = k.startswith("resnet.bn1.") or (
            trained is not None and not k.startswith(trained))
        assert torch.equal(last[k], v) == frozen, k
    # every BatchNorm, frozen or not, saw 2 epochs of 5 train steps
    assert int(last["resnet.layer1.0.bn1.num_batches_tracked"]) == 10


def test_k1_backward_ran_once_a_train_step(runs):
    # 15 bags of 2 in batches of 3: 5 steps an epoch
    assert runs["backward_calls"] == 10


def test_log_writes_the_jax_tags(runs):
    def metrics(out):
        (path,) = (out / "summary").glob("*_histo_model/metrics.jsonl")
        return [json.loads(line) for line in path.read_text().splitlines()]

    want, got = metrics(runs["jax"][0]), metrics(runs["torch"][0])
    assert [(r["tag"], r.get("step")) for r in got] == \
        [(r["tag"], r.get("step")) for r in want]
    for g, w in zip(got, want):
        if "value" in w and w["tag"] != "train/bags_per_s":
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{w['tag']} at step {w['step']}")


@pytest.mark.parametrize("split", SPLITS)
def test_savescore_serves_the_trained_model(runs, split):
    """``histo_savescore`` on each stack's trained ``model_last``."""
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    want = pd.read_csv(jax_out / f"serve/model_last_pathology_{split}_df.csv",
                       index_col=0)
    got = pd.read_csv(torch_out / f"serve/model_last.pt_pathology_{split}_df.csv",
                      index_col=0)
    assert list(got["id"]) == list(want["id"])
    assert np.isfinite(got["score"]).all()
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4, atol=1e-5)
