"""The port's joint-fusion CLIs (``joint_train``, ``joint_savescore``) and
the early-fusion CLIs (``feature_train``, ``feature_savescore``) against the
JAX CLIs, on the CPU (``--device cpu``).

The joint cohort is ``tests/test_joint_cli.py``'s ``joint_experiment``
(resnet18, 32-px patches, 16 genes, batches of 4) with one bag of 4
patches per slide, the train slides as the val split, ``dropout: 0`` and
``augment: false`` (the two stacks draw their masks and jitter from
different generators) and every LR at 1e-5 (the reason
``tests/test_torch_rna_cli.py`` gives: the Cox loss is blind to a shift of
the scores, so Adam steps elements whose gradient is float32 noise by a few
percent of the LR, in a direction the rounding picks; at the joint head's
reference LR of 1e-2 that alone moves the scores by ~1e-2). The fixture's
2 val slides give a Cox loss of ~1e-7 at every epoch, so float32 noise
would pick the best epoch; the 4 train slides do not. One bag per slide
because the fixture's bags of 2 make the run amplify float32 rounding
about 70-fold: there the port run against itself, from the same weights
each moved by one float32 ulp, parts by 6.6e-5 in score, as far as it
parts from the JAX run (6.3e-5), beyond ``rtol=1e-4`` on a score of 0.15;
with one bag per slide by 9.5e-7. ``tests/test_torch_joint_rounding.py``
keeps the two-bag cohort and holds the cross-stack gap to that witness.
Both
stacks start from one seeded ``.pt``; the JAX side reads it through
``torch_joint_to_flax``. Losses and frames are held at the histo
tolerances, ``rtol=1e-4, atol=1e-5``. ``joint_savescore`` serves each
stack's trained model in float, and the seeded weights with ``fold_bn:
true`` (``rtol=1e-4, atol=1e-5``) and with ``quantize: "int8"``, each stack
calibrating and quantizing on its own (``atol=0.1``, the int8 CLI
tolerance of ``tests/test_torch_quantize.py``; with one shared qtree the
adapters agree at ``atol=1e-2``).
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import (
    feature_savescore,
    feature_train,
    joint_savescore,
    joint_train,
)
from multimodalbrainsurvival_torch.cli.joint_train import (
    build_joint_model,
    build_joint_optimizer,
)
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.models.convert import (
    flax_joint_to_torch,
    flax_mlp_qtree_to_torch,
    flax_qtree_to_torch,
)
from multimodalbrainsurvival_torch.models.folding import fold_resnet_state_dict
from multimodalbrainsurvival_torch.train.adapters import (
    JointAdapter,
    QuantizedJointAdapter,
    QuantTrunkJointAdapter,
)
from tests.helpers import make_survival_csv
from tests.test_joint_cli import joint_experiment
from tests.test_torch_histo_cli import _random_state
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

SPLITS = ("train", "val", "test")
GENES, IMG = 16, 32
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _write(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


def _losses(log, tag):
    return [float(v) for v in re.findall(rf"^{tag} Loss: (\S+)$", log, re.M)]


def _save_flax(tree, path):
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    Checkpointer().save(path, jax.tree.map(np.asarray, tree), block=True)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """``joint_experiment``'s cohort and config, made once for the module,
    with the parity keys and a seeded initial model in both formats."""
    from multimodalbrainsurvival_tpu.models.convert import torch_joint_to_flax

    tmp = tmp_path_factory.mktemp("joint")
    tmp, cfg, _ = joint_experiment.__wrapped__(tmp)
    # val: the 4 train slides (the fixture's 2 val slides give a Cox loss
    # of ~1e-7 at every epoch, so float32 noise would pick the best epoch)
    cfg = dict(cfg, dropout=0.0, augment=False, num_epochs=2, log_interval=1,
               train_bag_size=4, val_bag_size=4, val_csv_path=cfg["train_csv_path"],
               lr_histo=1e-5, lr_rna=1e-5, lr_mlp=1e-5)
    state = _random_state(build_joint_model(Config(cfg), in_features=GENES), seed=21)
    pt = tmp / "init.pt"
    torch.save(state, str(pt))
    flax_init = str(tmp / "init_flax")
    _save_flax(torch_joint_to_flax({k: v.numpy() for k, v in state.items()}), flax_init)
    return tmp, cfg, state, {"jax": flax_init, "torch": str(pt)}


STACKS = {"jax": ([], "model_last"), "torch": (["--device", "cpu"], "model_last.pt")}


@pytest.fixture(scope="module")
def runs(experiment):
    """``joint_train`` through both stacks' CLI mains, then
    ``joint_savescore`` on the trained model, and on the initial one with
    ``fold_bn`` and with ``quantize: "int8"``."""
    from multimodalbrainsurvival_tpu.cli import (
        joint_savescore as jax_savescore,
        joint_train as jax_train,
    )

    tmp, cfg, _, init = experiment
    mains = {"jax": (jax_train.main, jax_savescore.main),
             "torch": (joint_train.main, joint_savescore.main)}
    result = {}
    for name, (train, serve) in mains.items():
        extra, last = STACKS[name]
        out = tmp / name
        c = dict(cfg, checkpoint_path=str(out) + "/", restore_path=init[name])
        log = _run(train, ["--config", _write(tmp / f"{name}_train.json", c)] + extra)
        model = str(out / "models/joint_model" / last)
        for mode, keys in (("float", {"model_path": model}),
                           ("folded", {"model_path": init[name], "fold_bn": True}),
                           ("int8", {"model_path": init[name], "quantize": "int8"})):
            s = dict(c, restore_path="", output_path=str(out / mode), **keys)
            log += _run(serve, ["--config", _write(tmp / f"{name}_{mode}.json", s)] + extra)
        result[name] = (out, log)
    return result


@pytest.mark.parametrize("tag", ["EPOCH", "TRAIN", "VAL"])
def test_joint_epoch_losses_match_jax(runs, tag):
    want, got = _losses(runs["jax"][1], tag), _losses(runs["torch"][1], tag)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **TOL)


def test_joint_best_epoch_matches_jax(runs):
    pattern = r"LOADING BEST MODEL, best epoch = (-?\d+)"
    assert re.findall(pattern, runs["torch"][1]) == re.findall(pattern, runs["jax"][1])


def trained_weights(out: dict) -> tuple[dict, dict]:
    """The port's and the JAX package's ``model_last`` of a pair of
    ``joint_train`` runs, both as the port's ``state_dict``."""
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    ours = torch.load(out["torch"] / "models/joint_model/model_last.pt", weights_only=True)
    tree = Checkpointer().restore(str(out["jax"] / "models/joint_model/model_last"))
    theirs = flax_joint_to_torch(jax.tree.map(np.asarray, tree["params"]),
                                 jax.tree.map(np.asarray, tree["batch_stats"]))
    assert sorted(ours) == sorted(theirs)
    return ours, theirs


def trained_group(cfg: dict, key: str) -> float | None:
    """The LR of the Adam group that trains ``key`` at ``n_layers_to_train``
    2, None for a frozen tensor."""
    lr = {"resnet.layer4.": cfg["lr_histo"], "rna_mlp.": cfg["lr_rna"],
          "final_mlp.": cfg["lr_mlp"]}
    return next((v for g, v in lr.items() if key.startswith(g)), None)


def assert_within_adam_ceiling(ours: dict, theirs: dict, init: dict, cfg: dict,
                               steps: int) -> None:
    """All but 1% of each trained tensor's elements within a quarter of its
    LR of the JAX package's (each Adam step went the same way), every
    element within 2·LR·steps (the most two Adam runs part by when an
    element's gradient is noise), each tensor moved; the frozen weights
    equal; the running statistics at ``rtol=2e-3, atol=2e-3`` (the band of
    ``tests/test_torch_histo_train.py``)."""
    for k, v in ours.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), theirs[k].numpy(), rtol=2e-3, atol=2e-3)
            continue
        if k.endswith("num_batches_tracked"):
            continue  # not kept by the JAX package
        lr = trained_group(cfg, k)
        if lr is None:
            assert torch.equal(v, theirs[k]), k
            continue
        diff = (v - theirs[k]).abs()
        assert diff.max().item() <= 2 * lr * steps, k
        assert (diff > lr / 4).float().mean().item() <= 0.01, k
        assert (v - init[k]).abs().max().item() > lr / 2, k


def test_joint_last_weights_match_jax(experiment, runs):
    """The trained weights within the Adam ceiling of the JAX package's
    (``assert_within_adam_ceiling``), after one batch of 4 bags an epoch."""
    _, cfg, init, _ = experiment
    ours, theirs = trained_weights({name: out for name, (out, _) in runs.items()})
    assert_within_adam_ceiling(ours, theirs, init, cfg, steps=2)


@pytest.mark.parametrize("tag", ["last", "best"])
@pytest.mark.parametrize("split", SPLITS)
def test_joint_train_frames_match_jax(runs, split, tag):
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    name = f"outputs/joint_model/{split}_output_{tag}.csv"
    want, got = pd.read_csv(jax_out / name), pd.read_csv(torch_out / name)
    assert list(got.columns) == ["id", "score", "survival_months", "vital_status"]
    assert list(got["id"]) == list(want["id"])
    np.testing.assert_allclose(got["score"], want["score"], **TOL)


@pytest.mark.parametrize("mode", ["float", "folded", "int8"])
@pytest.mark.parametrize("split", SPLITS)
def test_joint_savescore_frames_match_jax(runs, split, mode):
    """Case-level frames ``<model_file>_joint_<split>_df.csv``."""
    (jax_out, _), (torch_out, log) = runs["jax"], runs["torch"]
    model = {"float": "model_last", "folded": "init", "int8": "init"}[mode]
    (want_path,) = (jax_out / mode).glob(f"*_joint_{split}_df.csv")
    got_path = torch_out / mode / f"{model}.pt_joint_{split}_df.csv"
    want = pd.read_csv(want_path, index_col=0)
    got = pd.read_csv(got_path, index_col=0)
    assert list(got.columns) == ["id", "score", "survival_months", "vital_status"]
    assert list(got["id"]) == list(want["id"])
    if mode == "int8":
        assert "quantized ResNet + RNA encoder to int8" in log
        np.testing.assert_allclose(got["score"], want["score"], rtol=0, atol=0.1)
    else:
        np.testing.assert_allclose(got["score"], want["score"], **TOL)


@pytest.mark.parametrize("n", range(7))
def test_joint_ladder_trains_what_jax_trains(n):
    """At every ``n_layers_to_train`` the parameters the port trains, and
    their groups, are those the JAX package's labels give (``resnet.fc``
    matches nothing; ``resnet.bn1`` stays frozen)."""
    from multimodalbrainsurvival_tpu.cli.joint_train import (
        build_joint_model as jax_build,
        build_joint_optimizer as jax_optimizer,
    )
    from multimodalbrainsurvival_tpu.config import Config as JaxConfig

    cfg = {"model_name": "resnet18", "num_classes": 1, "n_layers_to_train": n,
           "lr_histo": 1e-4, "lr_rna": 1e-4, "lr_mlp": 1e-4, "weight_decay": 0.0}
    jmodel = jax_build(JaxConfig(cfg))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, IMG, IMG, 3)),
                            jnp.zeros((1, GENES)), mask=jnp.ones((1, 1), bool), train=False)
    _, labels = jax_optimizer(variables["params"], JaxConfig(cfg))
    codes = {"_frozen": 0.0, "histo": 1.0, "rna": 2.0, "mlp": 3.0}
    coded = jax.tree_util.tree_map_with_path(
        lambda path, p: np.full(np.shape(p), codes[_label(labels, path)], np.float32),
        jax.tree.map(np.asarray, variables["params"]))
    want = {k: v.flatten()[0].item() for k, v in flax_joint_to_torch(coded).items()
            if not k.endswith("num_batches_tracked")}

    model = build_joint_model(Config(cfg), in_features=GENES)
    optimizer = build_joint_optimizer(model, Config(cfg))
    group_of = {id(p): g["name"] for g in optimizer.param_groups for p in g["params"]}
    got = {name: codes[group_of[id(p)]] if p.requires_grad else 0.0
           for name, p in model.named_parameters()}
    assert got == want
    assert not model.resnet.bn1.weight.requires_grad


def _label(labels, path):
    for key in path:
        labels = labels[key.key]
    return labels


def test_frozen_trunk_joint_step_gives_zero_gradients_below_the_seam(experiment):
    """``QuantTrunkJointAdapter`` with the whole model asking for gradients:
    the int8 trunk (stem + 3 stages) receives none, layer4, the RNA encoder
    and the head do."""
    from multimodalbrainsurvival_torch.cli._common import build_datasets
    from multimodalbrainsurvival_torch.data import PatchBagRNADataset
    from multimodalbrainsurvival_torch.models.quantize import quantize_trunk_for_training
    from multimodalbrainsurvival_torch.train.loop import make_loss_fn
    from multimodalbrainsurvival_torch.train import TrainSettings

    _, cfg, state, _ = experiment
    model = build_joint_model(Config(cfg), in_features=GENES)
    model.load_state_dict(state)
    train = build_datasets(Config(cfg), False, PatchBagRNADataset)["train"]
    batch = next(train.batches(4, num_threads=1))
    qtree = quantize_trunk_for_training(model.resnet, [batch["patch_bag"]],
                                        arch="resnet18", augment=False)
    adapter = QuantTrunkJointAdapter(model=model, device=torch.device("cpu"), augment=False,
                                     qtree=qtree, trunk_stages=3, arch="resnet18")
    keys = adapter.array_keys + ("survival_months", "vital_status")
    arrays = adapter.to_device(batch, keys)
    loss_fn, _ = make_loss_fn(TrainSettings())
    out = adapter.apply(arrays, train=True, generator=torch.Generator().manual_seed(0))
    loss_fn(out, arrays, arrays["sample_mask"]).backward()
    below = ("resnet.conv1.", "resnet.bn1.", "resnet.layer1.", "resnet.layer2.",
             "resnet.layer3.")
    for name, p in model.named_parameters():
        if name.startswith(below):
            assert p.grad is None or not p.grad.any(), name
        elif name.startswith(("resnet.layer4.", "rna_mlp.", "final_mlp.")) \
                and name.endswith("weight"):
            assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_joint_train_quantize_trunk_runs(experiment, tmp_path, monkeypatch):
    """``quantize_trunk: "int8"`` in the port's ``joint_train``: the joint
    frozen-trunk adapter with stem + 3 stages at ``n_layers_to_train`` 2,
    finite frames, and a float checkpoint the float ``joint_savescore``
    serves."""
    _, cfg, _, init = experiment
    built = {}
    original = QuantTrunkJointAdapter.__init__

    def spy(self, *args, **kwargs):
        original(self, *args, **kwargs)
        built["trunk_stages"] = self.trunk_stages

    monkeypatch.setattr(QuantTrunkJointAdapter, "__init__", spy)
    c = dict(cfg, checkpoint_path=str(tmp_path / "out") + "/", quantize_trunk="int8",
             num_epochs=1, restore_path=init["torch"])
    _run(joint_train.main, ["--config", _write(tmp_path / "train.json", c), "--device", "cpu"])
    assert built == {"trunk_stages": 3}
    frame = pd.read_csv(tmp_path / "out/outputs/joint_model/val_output_last.csv")
    assert len(frame) > 0 and np.isfinite(frame["score"]).all()
    s = dict(c, model_path=str(tmp_path / "out/models/joint_model/model_last.pt"),
             output_path=str(tmp_path / "serve"), restore_path="")
    s.pop("quantize_trunk")
    _run(joint_savescore.main, ["--config", _write(tmp_path / "s.json", s), "--device", "cpu"])
    got = pd.read_csv(tmp_path / "serve/model_last.pt_joint_val_df.csv", index_col=0)
    assert np.isfinite(got["score"]).all()


def test_int8_joint_adapter_from_jax_qtrees_matches_jax(experiment):
    """The int8 joint adapters of both stacks, end to end from uint8 bags,
    with the JAX package's qtrees (ResNet calibrated on the batch, RNA
    encoder) and one set of folded float weights: scores within
    ``atol=1e-2``."""
    from multimodalbrainsurvival_tpu.cli.joint_train import build_joint_model as jax_build
    from multimodalbrainsurvival_tpu.config import Config as JaxConfig
    from multimodalbrainsurvival_tpu.models import quantize as jq
    from multimodalbrainsurvival_tpu.models.convert import torch_joint_to_flax
    from multimodalbrainsurvival_tpu.models.folding import fold_resnet_variables
    from multimodalbrainsurvival_tpu.train.adapters import (
        QuantizedJointAdapter as JaxQuantizedJoint,
    )

    _, cfg, state, _ = experiment
    rng = np.random.default_rng(23)
    bag = rng.integers(0, 256, (3, 2, IMG, IMG, 3), np.uint8)
    mask = np.array([[True, True], [True, False], [True, True]])
    rna = rng.standard_normal((3, GENES)).astype(np.float32)
    folded = jax.tree.map(np.asarray, fold_resnet_variables(
        torch_joint_to_flax({k: v.numpy() for k, v in state.items()})))
    qtree = jq.quantize_mil_resnet(folded, [bag], arch="resnet18")
    qtree_rna = jq.quantize_rna_encoder(folded, submodule="rna_encoder")
    jax_adapter = JaxQuantizedJoint(model=jax_build(JaxConfig(cfg), fold_bn=True),
                                    arch="resnet18")
    variables = {"params": folded["params"], "qtree": qtree, "qtree_rna": qtree_rna}
    jarrays = {"patch_bag": jnp.asarray(bag), "bag_mask": jnp.asarray(mask),
               "sample_mask": jnp.ones((3,), bool), "rna_data": jnp.asarray(rna)}
    want, _ = jax_adapter.apply(variables, jarrays, train=False)

    model = build_joint_model(Config(cfg), fold_bn=True, in_features=GENES).eval()
    model.load_state_dict(fold_resnet_state_dict(state))
    adapter = QuantizedJointAdapter(
        model=model, device=torch.device("cpu"), qtree=flax_qtree_to_torch(qtree),
        qtree_rna=flax_mlp_qtree_to_torch(jax.tree.map(np.asarray, qtree_rna)),
        arch="resnet18")
    arrays = {"patch_bag": torch.from_numpy(bag), "bag_mask": torch.from_numpy(mask),
              "rna_data": torch.from_numpy(rna)}
    np.testing.assert_allclose(adapter.apply(arrays).numpy(), np.asarray(want),
                               rtol=0, atol=1e-2)
    assert adapter.extract(arrays).shape == (3, 512 + 2048)
    with pytest.raises(ValueError, match="eval-only"):
        adapter.apply(arrays, train=True)


def test_joint_cache_patches_on_device_raises(experiment, tmp_path):
    """With a ``mesh`` of 2 in a world of one process the cached run raises
    naming the launcher, as any such mesh does (the mesh-sharded cache:
    ``tests/test_torch_parallel_cache.py``)."""
    _, cfg, _, _ = experiment
    c = dict(cfg, checkpoint_path=str(tmp_path) + "/", cache_patches_on_device=True,
             mesh={"dp": 2, "mp": 1})
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node"):
        joint_train.main(["--config", _write(tmp_path / "c.json", c), "--device", "cpu"])


def test_joint_adapter_train_draws_the_seed_first(experiment):
    """A joint train step draws its dropout seed from the loop's generator
    before any other draw (the augmentation's), so a draw from the card's
    generator finds nothing queued behind it."""
    _, cfg, state, _ = experiment
    model = build_joint_model(Config(dict(cfg, dropout=0.5)), in_features=GENES)
    model.load_state_dict(state)
    adapter = JointAdapter(model=model, device=torch.device("cpu"), augment=True)
    from multimodalbrainsurvival_torch.cli._common import build_datasets
    from multimodalbrainsurvival_torch.data import PatchBagRNADataset

    batch = next(build_datasets(Config(cfg), False, PatchBagRNADataset)["train"].batches(
        4, num_threads=1))
    arrays = adapter.to_device(batch, adapter.array_keys)
    outs = [adapter.apply(arrays, train=True, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


# --- early fusion ------------------------------------------------------------------


@pytest.fixture(scope="module")
def feature_runs(tmp_path_factory):
    """``feature_train`` (2 epochs, dropout 0, LR 1e-5, ``--log 1``) →
    ``feature_savescore`` through both stacks' CLI mains, from one seeded
    ``.pt``, on a 64-feature cohort with padded last batches."""
    from multimodalbrainsurvival_tpu.cli import (
        feature_savescore as jax_savescore,
        feature_train as jax_train,
    )
    from multimodalbrainsurvival_tpu.models.convert import torch_feature_to_flax

    tmp = tmp_path_factory.mktemp("early")
    for split, n, seed in (("train", 20, 1), ("val", 10, 2), ("test", 9, 3)):
        make_survival_csv(str(tmp / f"{split}.csv"), [f"{split}{i}" for i in range(n)],
                          n_feature=64, seed=seed)
    state = _random_state(feature_train.build_feature_model(None, 64), seed=5)
    torch.save(state, str(tmp / "init.pt"))
    _save_flax(torch_feature_to_flax({k: v.numpy() for k, v in state.items()}),
               str(tmp / "init_flax"))
    cfg = {"batch_size": 8, "num_epochs": 2, "lr": 1e-5, "weight_decay": 1e-5,
           "dropout": 0.0, "flag": "feature_model", "log_interval": 1,
           **{f"{s}_csv_path": str(tmp / f"{s}.csv") for s in SPLITS}}
    result = {}
    for name, train, serve, init in (
        ("jax", jax_train.main, jax_savescore.main, str(tmp / "init_flax")),
        ("torch", feature_train.main, feature_savescore.main, str(tmp / "init.pt")),
    ):
        extra, last = STACKS[name]
        out = tmp / name
        c = dict(cfg, checkpoint_path=str(out) + "/", restore_path=init)
        log = _run(train, ["--config", _write(tmp / f"{name}.json", c), "--log", "1"]
                   + extra)
        s = dict(c, model_path=str(out / "models/feature_model" / last),
                 output_path=str(out / "serve"))
        log += _run(serve, ["--config", _write(tmp / f"{name}_s.json", s)] + extra)
        result[name] = (out, log)
    return result


@pytest.mark.parametrize("tag", ["EPOCH", "TRAIN", "VAL"])
def test_feature_losses_match_jax(feature_runs, tag):
    """Three epochs' worth of TRAIN / VAL lines: the pre-training eval
    (epoch -1) and the two epochs'."""
    want, got = _losses(feature_runs["jax"][1], tag), _losses(feature_runs["torch"][1], tag)
    assert len(got) == len(want) == (2 if tag == "EPOCH" else 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tag", ["last", "best"])
@pytest.mark.parametrize("split", SPLITS)
def test_feature_train_frames_match_jax(feature_runs, split, tag):
    (jax_out, _), (torch_out, _) = feature_runs["jax"], feature_runs["torch"]
    name = f"outputs/feature_model/{split}_output_{tag}.csv"
    want, got = pd.read_csv(jax_out / name), pd.read_csv(torch_out / name)
    assert list(got["id"]) == list(want["id"])
    np.testing.assert_allclose(got["score"], want["score"], **TOL)


@pytest.mark.parametrize("split", SPLITS)
def test_feature_savescore_frames_match_jax(feature_runs, split):
    (jax_out, _), (torch_out, _) = feature_runs["jax"], feature_runs["torch"]
    want = pd.read_csv(jax_out / f"serve/model_last_feature_{split}_df.csv", index_col=0)
    got = pd.read_csv(torch_out / f"serve/model_last.pt_feature_{split}_df.csv",
                      index_col=0)
    assert list(got.columns) == ["id", "score", "survival_months", "vital_status"]
    assert list(got["id"]) == list(want["id"])
    np.testing.assert_allclose(got["score"], want["score"], **TOL)


def test_feature_log_writes_the_jax_metrics(feature_runs):
    """``--log 1``: the JAX CLI's (tag, step) sequence, the pre-training
    evals at step -1 included."""
    def metrics(out):
        (path,) = (out / "summary").glob("*_feature_model/metrics.jsonl")
        return [json.loads(line) for line in path.read_text().splitlines()]

    want, got = metrics(feature_runs["jax"][0]), metrics(feature_runs["torch"][0])
    assert [(r["tag"], r.get("step")) for r in got] == \
        [(r["tag"], r.get("step")) for r in want]
    assert ("val/loss", -1) in [(r["tag"], r.get("step")) for r in got]
