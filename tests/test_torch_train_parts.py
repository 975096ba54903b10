"""The model-side parts of histopathology training, on the CPU: the freeze
ladder, ``remat``, ``freeze_bn``, ``pretrained_path``, the int8 frozen
trunk, an epoch-boundary resume with augmentation on, and the CLI's
refusals.

- Freeze ladder: for each ``n`` in 0..6 the port's trainable parameters are
  the ones the JAX ``mil_freeze_ladder`` labels trainable; ``resnet.bn1`` is
  frozen even at 6.
- ``remat``: the same loss, gradients and running statistics as without it
  (bit for bit on the CPU); an integer raises and names the list form.
- ``freeze_bn``: train mode normalizes with the running statistics and
  leaves them unchanged, while the affine still gets a gradient.
- int8 trunk: from one set of weights with ``augment: false``, the port's
  ``quantize_trunk_for_training`` qtree tracks the JAX one (int8 weights
  within one step, scales at ``rtol=1e-4``, as ``tests/test_torch_quantize
  .py`` holds calibration); from one shared qtree (``flax_qtree_to_torch``)
  the trunk adapters of both stacks give outputs within ``atol=1e-2`` and
  bag embeddings at cosine ≥ 0.9999; a ``quantize_trunk`` run trains.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.cli import histo_train
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model, load_pretrained
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.models import quantize as tq
from multimodalbrainsurvival_torch.models.convert import flax_qtree_to_torch
from multimodalbrainsurvival_torch.models.resnet import resnet18, resnet50
from multimodalbrainsurvival_torch.train.adapters import QuantTrunkMILAdapter
from multimodalbrainsurvival_torch.train.optim import (
    build_grouped_optimizer,
    mil_freeze_ladder,
)
from tests.test_torch_histo_cli import _random_state
from tests.test_torch_histo_train import (  # noqa: F401
    _config,
    _run,
    _write,
    cohort,
    few_threads,
)

IMG = 32
MIL_CFG = {"model_name": "resnet18", "aggregator": "attention", "num_classes": 1,
           "aggregator_hdim": 512}


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, axis=-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


# --- freeze ladder -------------------------------------------------------------


@pytest.mark.parametrize("n", range(7))
def test_freeze_ladder_trains_what_jax_labels_trainable(n):
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
    from multimodalbrainsurvival_tpu.train.optim import (
        build_grouped_optimizer as jax_build,
    )
    from multimodalbrainsurvival_tpu.train.optim import mil_freeze_ladder as jax_ladder
    from multimodalbrainsurvival_tpu.train.optim import torch_adam
    from multimodalbrainsurvival_torch.models.convert import flax_mil_to_torch

    model = build_mil_model(Config(MIL_CFG))
    opt = build_grouped_optimizer(model, [("train", mil_freeze_ladder(n), 1e-3)], 1e-4)
    ours = {k for k, p in model.named_parameters() if p.requires_grad}
    assert ours == {k for k, p in model.named_parameters()
                    if any(p is q for g in opt.param_groups for q in g["params"])}

    params = torch_mil_to_flax({k: v.numpy() for k, v in model.state_dict().items()})["params"]
    _, labels = jax_build(params, [("train", jax_ladder(n), torch_adam(1e-3))])
    # the label tree as 0/1 arrays of each parameter's shape, renamed by the
    # port's converter
    ones = jax.tree.map(lambda lab, p: np.full(np.shape(p), lab == "train", np.float32),
                        labels, params)
    theirs = {k for k, v in flax_mil_to_torch(ones).items()
              if not k.endswith("num_batches_tracked") and bool(v.all())}
    assert ours == theirs
    assert not any(k.startswith("resnet.bn1.") for k in ours)
    assert any(k.startswith("aggregator.") for k in ours)
    assert any(k.startswith("resnet.conv1.") for k in ours) == (n >= 6)


# --- remat, freeze_bn ------------------------------------------------------


def _train_pass(model, x, seed=0):
    model.train()
    g = torch.Generator().manual_seed(seed)
    target = torch.randn(x.shape[0], model.feature_dim, generator=g)
    loss = (model.extract(x) * target).sum()
    loss.backward()
    return loss.detach()


@pytest.mark.parametrize("remat", [True, [1, 2], [4]], ids=["all", "1_2", "4"])
def test_remat_gives_the_same_gradients_and_statistics(remat):
    x = torch.randn(4, 3, IMG, IMG, generator=torch.Generator().manual_seed(1))
    torch.manual_seed(0)
    plain = resnet18(num_classes=None)
    torch.manual_seed(0)
    rematted = resnet18(num_classes=None, remat=remat)
    assert rematted.remat_stages
    losses = [_train_pass(m, x) for m in (plain, rematted)]
    assert torch.equal(*losses)
    for (name, p), q in zip(plain.named_parameters(), rematted.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=0, msg=name)
    for (name, b), c in zip(plain.named_buffers(), rematted.buffers()):
        assert torch.equal(b, c), name  # one update, not two


@pytest.mark.parametrize("bad", [1, 0, 2, "12", [5], [0]])
def test_remat_refuses_what_it_does_not_take(bad):
    with pytest.raises(ValueError, match=r"remat|list of 1-based|out of range"):
        resnet18(num_classes=None, remat=bad)
    if isinstance(bad, int):
        with pytest.raises(ValueError, match=r"\[1, 2\]"):
            resnet18(num_classes=None, remat=bad)


def test_freeze_bn_uses_and_keeps_the_running_statistics():
    torch.manual_seed(0)
    model = resnet50(num_classes=None, freeze_bn=True)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():  # statistics away from the identity
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    x = torch.randn(2, 3, IMG, IMG, generator=torch.Generator().manual_seed(2))
    model.eval()
    with torch.no_grad():
        want = model.extract(x)
    _train_pass(model, x)
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    model.train()
    with torch.no_grad():
        torch.testing.assert_close(model.extract(x), want, rtol=0, atol=0)
    assert model.bn1.weight.grad is not None and model.bn1.weight.grad.abs().sum() > 0
    assert set(model.state_dict()) == set(state)


# --- pretrained_path -----------------------------------------------------------


@pytest.mark.parametrize("prefixed", [False, True], ids=["torchvision", "resnet_prefix"])
def test_pretrained_path_loads_a_local_pt(tmp_path, capsys, prefixed):
    torch.manual_seed(3)
    imagenet = resnet18(num_classes=1000)  # torchvision keys, 1000-class head
    state = imagenet.state_dict()
    if prefixed:
        state = {f"resnet.{k}": v for k, v in state.items()}
    path = tmp_path / "resnet18_imagenet.pt"
    torch.save(state, path)
    model = build_mil_model(Config(MIL_CFG))
    load_pretrained(model, Config(dict(MIL_CFG, pretrained=True, pretrained_path=str(path))))
    assert "Loaded pretrained ResNet weights" in capsys.readouterr().out
    for k, v in model.resnet.state_dict().items():
        assert torch.equal(v, imagenet.state_dict()[k]), k
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained(model, Config(dict(MIL_CFG, pretrained=True)))
    assert "no 'pretrained_path' given" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# --- int8 frozen trunk ---------------------------------------------------------


def _bags(seed, b=2, bag=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, bag, IMG, IMG, 3), np.uint8)


def _trunk_models(seed=13):
    """The port's model with seeded weights, and the same numbers as the
    JAX package's variables."""
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax

    model = build_mil_model(Config(MIL_CFG))
    state = _random_state(model, seed=seed)
    model.load_state_dict(state)
    variables = jax.tree.map(jnp.asarray, torch_mil_to_flax(
        {k: v.numpy() for k, v in state.items()}))
    return model.eval(), variables


def test_trunk_qtree_tracks_jax_calibration():
    from multimodalbrainsurvival_tpu.models import quantize as jq

    model, variables = _trunk_models()
    bags = [_bags(20), _bags(21)]
    want = flax_qtree_to_torch(jax.device_get(jq.quantize_trunk_for_training(
        variables, bags, arch="resnet18", augment=False)))
    got = tq.quantize_trunk_for_training(model.resnet, bags, arch="resnet18",
                                         augment=False)
    assert set(got["scales"]) == set(want["scales"])
    for site, s in want["scales"].items():
        np.testing.assert_allclose(got["scales"][site].item(), s.item(), rtol=1e-4,
                                   err_msg=site)
    for key in set(want) - {"scales"}:
        convs = {"": want[key]} if key == "conv1" else want[key]
        mine = {"": got[key]} if key == "conv1" else got[key]
        assert set(mine) == set(convs), key
        for name, cp in convs.items():
            diff = (mine[name]["k"].int() - cp["k"].int()).abs()
            assert diff.max() <= 1 and diff.float().mean() < 1e-3, f"{key}.{name}"
            torch.testing.assert_close(mine[name]["ws"], cp["ws"], rtol=1e-5, atol=0)
            torch.testing.assert_close(mine[name]["b"], cp["b"], rtol=1e-4, atol=1e-6)


def test_trunk_qtree_calibrates_on_augmented_pixels():
    model, _ = _trunk_models()
    bags = [_bags(22)]
    plain = tq.quantize_trunk_for_training(model.resnet, bags, arch="resnet18",
                                           augment=False)
    aug = [tq.quantize_trunk_for_training(model.resnet, bags, arch="resnet18",
                                          augment=True, seed=s) for s in (0, 0, 1)]
    assert aug[0]["scales"]["stem"] == aug[1]["scales"]["stem"]
    assert aug[0]["scales"]["stem"] != plain["scales"]["stem"]
    assert aug[0]["scales"]["stem"] != aug[2]["scales"]["stem"]


@pytest.mark.parametrize("stages", [1, 3])
def test_trunk_adapter_from_a_shared_qtree_matches_jax(stages):
    from multimodalbrainsurvival_tpu.cli.histo_train import (
        build_mil_model as jax_build_mil_model,
    )
    from multimodalbrainsurvival_tpu.config import Config as JaxConfig
    from multimodalbrainsurvival_tpu.models import quantize as jq
    from multimodalbrainsurvival_tpu.train.adapters import (
        QuantTrunkMILAdapter as JaxTrunkAdapter,
    )

    model, variables = _trunk_models(seed=14)
    bag = _bags(23)
    mask = np.array([[True, True, True], [True, False, False]])
    qtree = jax.device_get(jq.quantize_trunk_for_training(
        variables, [bag], arch="resnet18", augment=False))
    jax_adapter = JaxTrunkAdapter(model=jax_build_mil_model(JaxConfig(MIL_CFG)),
                                  augment=False, arch="resnet18",
                                  trunk_stages=stages, qtree=qtree)
    jarrays = {"patch_bag": jnp.asarray(bag), "bag_mask": jnp.asarray(mask),
               "sample_mask": jnp.ones((2,), bool)}
    want_out, _ = jax_adapter.apply(variables, jarrays, train=False)
    want_emb = jax_adapter.extract(variables, jarrays)

    adapter = QuantTrunkMILAdapter(model=model, device=torch.device("cpu"),
                                   augment=False, qtree=flax_qtree_to_torch(qtree),
                                   trunk_stages=stages, arch="resnet18")
    arrays = {"patch_bag": torch.from_numpy(bag), "bag_mask": torch.from_numpy(mask)}
    np.testing.assert_allclose(adapter.apply(arrays).numpy(), np.asarray(want_out),
                               rtol=0, atol=1e-2)
    assert _cosines(adapter.extract(arrays).numpy(), np.asarray(want_emb)).min() >= 0.9999


def test_trunk_training_step_leaves_the_frozen_prefix_alone():
    """A train step through the trunk adapter: the trainable tail gets
    gradients, the frozen prefix's parameters and BatchNorm statistics do
    not move (the documented deviation of ``quantized_trunk``)."""
    model, _ = _trunk_models(seed=15)
    opt = build_grouped_optimizer(model, [("train", mil_freeze_ladder(2), 1e-3)])
    qtree = tq.quantize_trunk_for_training(model.resnet, [_bags(24)], arch="resnet18",
                                           augment=True, seed=0)
    adapter = QuantTrunkMILAdapter(model=model, device=torch.device("cpu"),
                                   qtree=qtree, trunk_stages=3, arch="resnet18")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    arrays = {"patch_bag": torch.from_numpy(_bags(25)),
              "bag_mask": torch.ones(2, 3, dtype=torch.bool)}
    out = adapter.apply(arrays, train=True, generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    opt.step()
    after = model.state_dict()
    for k, v in before.items():
        moved = not torch.equal(after[k], v)
        tail = k.startswith(("fc.", "aggregator.", "resnet.layer4."))
        assert moved == (tail and "num_batches" not in k) or (
            tail and k.endswith("num_batches_tracked")), k


def test_quantize_trunk_run_trains(cohort, tmp_path):  # noqa: F811
    out = tmp_path / "out"
    cfg = _config(cohort, out, augment=True, quantize_trunk="int8", num_epochs=1,
                  lr=1e-3, max_patch_per_wsi_train=4, max_patch_per_wsi_val=2)
    log = _run(histo_train.main, ["--config", _write(tmp_path / "cfg.json", cfg),
                                  "--device", "cpu"])
    assert "int8 frozen prefix = stem + 3 stage(s)" in log
    save = out / "models/histo_model"
    last = torch.load(save / "model_last.pt", weights_only=True)
    init = torch.load(save / "train_state.pt", weights_only=True)
    assert set(last) == set(build_mil_model(Config(cfg)).state_dict())
    for split in ("train", "val", "test"):
        frame = (out / f"outputs/histo_model/{split}_output_last.csv").read_text()
        scores = [float(line.split(",")[1]) for line in frame.splitlines()[1:]]
        assert scores and np.isfinite(scores).all()
    assert not torch.equal(last["fc.weight"], torch.zeros_like(last["fc.weight"]))
    assert init["meta"]["step"] == 4  # 10 bags of 2 in batches of 3


@pytest.mark.parametrize("n", [5, 6])
def test_quantize_trunk_needs_a_frozen_stage(cohort, tmp_path, n):  # noqa: F811
    cfg = _config(cohort, tmp_path / "out", quantize_trunk="int8", n_layers_to_train=n)
    with pytest.raises(ValueError, match="n_layers_to_train <= 4"):
        histo_train.main(["--config", _write(tmp_path / "cfg.json", cfg), "--device", "cpu"])


# --- resume, refusals ----------------------------------------------------------


def test_epoch_boundary_resume_with_augmentation_is_exact(cohort, tmp_path):  # noqa: F811
    """One epoch, then a resumed second epoch, with the flips and jitter
    on: the weights equal a straight two-epoch run's bit for bit (the
    augmentation generator's state is in ``train_state.pt`` and the resume
    replays the dataset's per-epoch shuffles)."""
    weights = {}
    for name, epochs in (("straight", [2]), ("resumed", [1, 2])):
        for n in epochs:
            cfg = _config(cohort, tmp_path / name, augment=True, num_epochs=n,
                          lr=1e-3, n_layers_to_train=6,
                          resume=len(epochs) == 2 and n == 2)
            log = _run(histo_train.main,
                       ["--config", _write(tmp_path / f"{name}{n}.json", cfg),
                        "--device", "cpu"])
        assert ("Resumed full train state" in log) == (name == "resumed")
        weights[name] = torch.load(tmp_path / name / "models/histo_model/model_last.pt",
                                   weights_only=True)
    for k, v in weights["straight"].items():
        assert torch.equal(weights["resumed"][k], v), k


def test_augmentation_draws_change_training(cohort, tmp_path):  # noqa: F811
    """The flips and jitter reach the model: with ``augment`` on, training
    moves the weights elsewhere than with it off, and another seed draws
    other augmentations."""
    last = {}
    for name, augment, seed in (("off", False, "1111"), ("on", True, "1111"),
                                ("on_seed2", True, "2")):
        cfg = _config(cohort, tmp_path / name, augment=augment, num_epochs=1, lr=1e-3)
        _run(histo_train.main, ["--config", _write(tmp_path / f"{name}.json", cfg),
                                "--device", "cpu", "--seed", seed])
        last[name] = torch.load(tmp_path / name / "models/histo_model/model_last.pt",
                                weights_only=True)["fc.weight"]
    assert not torch.equal(last["on"], last["off"])
    assert not torch.equal(last["on"], last["on_seed2"])


def test_unported_and_ignored_keys(cohort, tmp_path, capsys):  # noqa: F811
    path = _write(tmp_path / "cache.json",
                  _config(cohort, tmp_path / "out", cache_patches_on_device=True))
    with pytest.raises(NotImplementedError, match="item 11"):
        histo_train.main(["--config", path, "--device", "cpu"])
    cfg = _config(cohort, tmp_path / "out", num_epochs=1, emergency_checkpoint=True)
    histo_train.main(["--config", _write(tmp_path / "cfg.json", cfg), "--device", "cpu"])
    out, err = capsys.readouterr()
    assert "ignoring keys with no meaning in the port: emergency_checkpoint" in out
    assert "a SIGTERM loses the work done since the last epoch boundary" in err


def test_train_without_card_defaults_to_cuda_and_raises(cohort, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(tmp_path / "cfg.json", _config(cohort, tmp_path / "out"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        histo_train.main(["--config", path])
    assert json.loads(open(path).read())["flag"] == "histo_model"
