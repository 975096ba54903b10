"""The port's fusion models and their data against the JAX package, on the
CPU, and the repair of fault F4.

Weights are made with numpy from a seed (``_random_state``) and carried to
the flax modules by the JAX package's own converters (``torch_feature_to_
flax``, ``torch_joint_to_flax``), and back by the port's
(``flax_feature_to_torch``, ``flax_joint_to_torch``). At small size
(resnet18, 32-px patches, 16 genes) in float32 the outputs are held at
``rtol=1e-4, atol=1e-5``: float32 convolutions and products summed in
another order. The RNA encoder in bf16 is held at 2**-7 of its scale: both
stacks round each layer's output to bf16, after sums in another order;
its gradients too, and alone in the JAX package XLA on the CPU sums a
bias's bf16 gradient over the batch in bf16, so the port's bias gradients
are held against JAX's per-row gradients summed and rounded once.

The train-mode paths (``DropoutMatmul``, K2a's plain version on the CPU)
at ``dropout: 0`` give the eval outputs; the datasets give the JAX
package's batches, the RNA vector following its slide through the
per-epoch shuffles and a resume's skipped batches.

F4: a second ``train_model`` run into the first run's ``save_dir`` that
keeps no best of its own (``num_epochs: 1`` with ``best_from_epoch: 1``)
reports its last weights as its best, not the first run's file; a run
resumed from the state keeps the best it restored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.data import FeatureTableDataset, PatchBagRNADataset
from multimodalbrainsurvival_torch.models import (
    RESNET_CONSTRUCTORS,
    BagHistopathologyRNAModel,
    EarlyFusionMLP,
    PatchHistopathologyRNAModel,
    RNAEncoder,
)
from multimodalbrainsurvival_torch.models.convert import (
    flax_feature_to_torch,
    flax_joint_to_torch,
    load_reference_state_dict,
)
from multimodalbrainsurvival_torch.train import TrainSettings, train_model
from multimodalbrainsurvival_torch.train.adapters import TableAdapter
from multimodalbrainsurvival_torch.train.optim import build_grouped_optimizer, wrap_optimizer
from multimodalbrainsurvival_tpu.models.convert import (
    torch_feature_to_flax,
    torch_joint_to_flax,
)
from tests.helpers import make_patch_dir, make_survival_csv
from tests.test_torch_histo_cli import _random_state
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

GENES, IMG = 16, 32
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _numpy_state(state):
    return {k: v.numpy() for k, v in state.items()}


# --- early fusion --------------------------------------------------------------


def test_early_fusion_matches_flax():
    from multimodalbrainsurvival_tpu.models import EarlyFusionMLP as JaxEarly

    model = EarlyFusionMLP(64, (2048, 200), dropout=0.0)
    state = _random_state(model, seed=1)
    assert sorted(state) == sorted(f"{i}.{leaf}" for i in (1, 4, 7)
                                   for leaf in ("weight", "bias"))
    model.load_state_dict(state)
    variables = torch_feature_to_flax(_numpy_state(state))
    x = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    want = np.asarray(JaxEarly(hidden_dims=(2048, 200), dropout=0.0).apply(
        variables, jnp.asarray(x), train=False))
    got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # train mode at dropout 0: the three pairs through DropoutMatmul
    got_train = model.train()(torch.from_numpy(x), torch.Generator().manual_seed(5))
    np.testing.assert_allclose(got_train.detach().numpy(), want, **TOL)
    back = flax_feature_to_torch(jax.tree.map(np.asarray, variables["params"]))
    assert all(torch.equal(back[k], v) for k, v in state.items())


def test_early_fusion_dropout_draws_from_the_generator():
    model = EarlyFusionMLP(32, (64, 8), dropout=0.5).train()
    x = torch.randn(6, 32)
    a = model(x, torch.Generator().manual_seed(1))
    b = model(x, torch.Generator().manual_seed(1))
    c = model(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- joint fusion --------------------------------------------------------------


def _joint(genes=GENES, dtype=torch.float32, dropout=0.0):
    return BagHistopathologyRNAModel(
        RESNET_CONSTRUCTORS["resnet18"](num_classes=None, dtype=dtype),
        RNAEncoder(genes, (4096, 2048), dropout=dropout, dtype=dtype),
        head_dropout=dropout)


def _jax_joint():
    from multimodalbrainsurvival_tpu.models import (
        BagHistopathologyRNAModel as JaxJoint,
        RNAEncoder as JaxEncoder,
    )
    from multimodalbrainsurvival_tpu.models.resnet import RESNET_CONSTRUCTORS as JR

    return JaxJoint(resnet=JR["resnet18"](),
                    rna_encoder=JaxEncoder(hidden_dims=(4096, 2048), dropout=0.0),
                    head_dropout=0.0)


@pytest.fixture(scope="module")
def joint_pair():
    model = _joint()
    state = _random_state(model, seed=7)
    model.load_state_dict(state)
    rng = np.random.default_rng(8)
    bag = rng.standard_normal((2, 3, IMG, IMG, 3)).astype(np.float32)
    mask = np.array([[True, True, True], [True, False, False]])
    rna = rng.standard_normal((2, GENES)).astype(np.float32)
    variables = torch_joint_to_flax(_numpy_state(state))
    return model.eval(), state, variables, bag, mask, rna


def _nchw_bag(bag):
    return torch.from_numpy(bag).permute(0, 1, 4, 2, 3).contiguous()


def test_joint_forward_and_extract_match_flax(joint_pair):
    model, _, variables, bag, mask, rna = joint_pair
    jmodel = _jax_joint()
    args = (jnp.asarray(bag), jnp.asarray(rna))
    want = np.asarray(jmodel.apply(variables, *args, mask=jnp.asarray(mask), train=False))
    want_emb = np.asarray(jmodel.apply(variables, *args, mask=jnp.asarray(mask),
                                       train=False, method="extract"))
    x, r, m = _nchw_bag(bag), torch.from_numpy(rna), torch.from_numpy(mask)
    with torch.no_grad():
        got = model(x, r, m)
        got_emb = model.extract(x, r, m)
    assert got.shape == (2, 1) and got_emb.shape == (2, 512 + 2048)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_emb.numpy(), want_emb, **TOL)
    # the padded bag pools its one real patch: the mean ignores the padding
    with torch.no_grad():
        alone = model.extract(x[1:, :1], r[1:], m[1:, :1])
    np.testing.assert_allclose(got_emb[1:].numpy(), alone.numpy(), **TOL)


def test_joint_train_mode_at_dropout_0_is_the_eval_forward(joint_pair):
    model, state, _, bag, mask, rna = joint_pair
    train = _joint()
    train.load_state_dict(state)
    # eval-mode BatchNorm inside a train-mode model: only the K2 path differs
    train.train()
    train.resnet.eval()
    x, r, m = _nchw_bag(bag), torch.from_numpy(rna), torch.from_numpy(mask)
    got = train(x, r, m, seed=3)
    with torch.no_grad():
        want = model(x, r, m)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    got.sum().backward()
    assert train.rna_mlp[1].weight.grad.abs().sum() > 0
    assert train.final_mlp[1].weight.grad.abs().sum() > 0


def test_joint_from_trunk_matches_flax(joint_pair):
    model, _, variables, _, mask, rna = joint_pair
    fmap = np.random.default_rng(9).standard_normal((2, 3, 2, 2, 256)).astype(np.float32)
    want = np.asarray(_jax_joint().apply(
        variables, jnp.asarray(fmap), jnp.asarray(rna), mask=jnp.asarray(mask),
        train=False, from_stage=3, method="from_trunk"))
    flat = torch.from_numpy(fmap.reshape(6, 2, 2, 256)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model.from_trunk(flat, torch.from_numpy(rna), torch.from_numpy(mask),
                               from_stage=3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_joint_converters_round_trip_and_reference_pt_loads(joint_pair, tmp_path):
    """A reference-keyed ``.pt`` (the ``BagHistopathologyRNAModel`` keys, with
    the torchvision ResNet's unused ``fc``) loads unchanged; the port's
    converter inverts the JAX package's."""
    _, state, variables, _, _, _ = joint_pair
    back = flax_joint_to_torch(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]))
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    reference = dict(state, **{"resnet.fc.weight": torch.zeros(1000, 512),
                               "resnet.fc.bias": torch.zeros(1000)})
    torch.save(reference, str(tmp_path / "joint.pt"))
    fresh = _joint()
    fresh.load_state_dict(load_reference_state_dict(str(tmp_path / "joint.pt")))
    early = EarlyFusionMLP()
    torch.save({"state_dict": early.state_dict()}, str(tmp_path / "early.pt"))
    EarlyFusionMLP().load_state_dict(load_reference_state_dict(str(tmp_path / "early.pt")))


def _jax_bf16_encoder():
    from multimodalbrainsurvival_tpu.models import RNAEncoder as JaxEncoder

    return JaxEncoder(hidden_dims=(4096, 2048), dropout=0.0, dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def bf16_encoder():
    """A seeded bf16 ``RNAEncoder`` at dropout 0, its flax params, a (6,
    genes) input and a (6, 2048) cotangent."""
    enc = RNAEncoder(GENES, (4096, 2048), dropout=0.0, dtype=torch.bfloat16)
    state = _random_state(enc, seed=10)
    enc.load_state_dict(state)
    params = {f"dense_{i}": {"kernel": state[f"{j}.weight"].numpy().T,
                             "bias": state[f"{j}.bias"].numpy()}
              for i, j in enumerate((1, 4))}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, GENES)).astype(np.float32)
    cot = rng.standard_normal((6, 2048)).astype(np.float32)
    return enc, params, x, cot


def _assert_bf16_close(got, want, what):
    """Within 2**-7 of the scale: both stacks round each product to bf16
    after float32 sums in another order, so an element may sit one bf16
    ulp (at most 2**-7 of the largest) away."""
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= 2**-7 * np.abs(want).max(), what


def _bias_sum_rounded_once(per_row):
    """The (rows, N) per-row gradients of a bias summed exactly and rounded
    to bf16 once. XLA on the CPU sums a bf16 batch reduction in bf16,
    rounding after each row (about half the elements of a 6-row sum then
    differ by an ulp); the port sums in float32 and rounds once, as a
    reduction accumulated in float32 does (XLA on a TPU)."""
    total = torch.from_numpy(np.asarray(per_row, np.float64).sum(axis=0))
    return total.to(torch.bfloat16).float().numpy()


def test_bf16_rna_encoder_matches_flax(bf16_encoder):
    """The joint model's RNA encoder under ``compute_dtype: "bfloat16"``:
    bf16 operands, each layer rounded to bf16 with its bias added in bf16,
    float32 out, as the flax ``RNAEncoder(dtype=bfloat16)``; train mode at
    dropout 0 (K2a's bf16 form, plain on the CPU) gives the same."""
    enc, params, x, _ = bf16_encoder
    want = np.asarray(_jax_bf16_encoder().apply({"params": params}, jnp.asarray(x)))
    for mode in ("eval", "train"):
        getattr(enc, mode)()
        with torch.no_grad():
            got = enc(torch.from_numpy(x), seed=4)
        assert got.dtype == torch.float32
        _assert_bf16_close(got, want, mode)


def test_bf16_rna_encoder_gradients_match_jax(bf16_encoder):
    """The bf16 backward (``DropoutMatmul`` in train mode at dropout 0: the
    float32 cotangent rounded to bf16, dx and dW from bf16 products with
    float32 sums, the casts carrying them to the float32 leaves) against
    ``jax.grad`` of the flax ``RNAEncoder(dtype=bfloat16)``: dx and each
    layer's dW within 2**-7 of their scale; each bias's gradient against
    the per-row gradients JAX gives, summed and rounded once."""
    enc, params, x, cot = bf16_encoder
    jenc = _jax_bf16_encoder()

    def loss(p, x, c):
        return jnp.sum(jenc.apply({"params": p}, x, train=True) * c)

    grads, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x), jnp.asarray(cot))
    rows = jax.vmap(lambda xr, cr: jax.grad(loss)(params, xr[None], cr[None]))(
        jnp.asarray(x), jnp.asarray(cot))
    enc.train().zero_grad()
    xt = torch.from_numpy(x).requires_grad_()
    (enc(xt, seed=4) * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == enc[1].weight.grad.dtype == torch.float32
    _assert_bf16_close(xt.grad, gx, "dx")
    for i, j in enumerate((1, 4)):
        _assert_bf16_close(enc[j].weight.grad, np.asarray(grads[f"dense_{i}"]["kernel"]).T,
                           f"dense_{i} dW")
        _assert_bf16_close(enc[j].bias.grad,
                           _bias_sum_rounded_once(rows[f"dense_{i}"]["bias"]),
                           f"dense_{i} db")


def test_bf16_joint_head_gradients_match_jax(joint_pair):
    """The joint model's tail (``from_feats``: the masked bag mean, the bf16
    RNA encoder, the float32 head) in train mode at dropout 0 against
    ``jax.grad`` of the JAX model's ``from_feats`` with a bf16 RNA encoder:
    the head's weight and bias, the per-patch features' gradient (padded
    patches get none) and the RNA encoder's weights within 2**-7 of their
    scale (the head's input carries the bf16 embedding), the encoder's
    biases against JAX's per-row gradients summed and rounded once."""
    from multimodalbrainsurvival_tpu.models import BagHistopathologyRNAModel as JaxJoint
    from multimodalbrainsurvival_tpu.models.resnet import RESNET_CONSTRUCTORS as JR

    _, state, variables, _, mask, rna = joint_pair
    model = _joint(dtype=torch.bfloat16)
    model.load_state_dict(state)
    model.train()
    feats = np.random.default_rng(14).standard_normal((2, 3, 512)).astype(np.float32)
    cot = np.array([[0.7], [-1.3]], np.float32)
    jmodel = JaxJoint(resnet=JR["resnet18"](), rna_encoder=_jax_bf16_encoder(),
                      head_dropout=0.0)

    def loss(p, f, r, m, c):
        out = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, f, r,
                           mask=m, train=True, method="from_feats")
        return jnp.sum(out * c)

    args = tuple(jnp.asarray(a) for a in (feats, rna, mask, cot))
    grads, gfeats = jax.grad(loss, argnums=(0, 1))(variables["params"], *args)
    rows = jax.vmap(lambda f, r, m, c: jax.grad(loss)(
        variables["params"], f[None], r[None], m[None], c[None]))(*args)
    grads = flax_joint_to_torch(jax.tree.map(np.asarray, grads))
    rows = jax.tree.map(np.asarray, rows["rna_encoder"])

    ft = torch.from_numpy(feats).requires_grad_()
    out = model.from_feats(ft, torch.from_numpy(rna), torch.from_numpy(mask), seed=6)
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_bf16_close(ft.grad, gfeats, "feats")
    assert not ft.grad[1, 1:].any()
    for name in ("final_mlp.1.weight", "final_mlp.1.bias", "rna_mlp.1.weight",
                 "rna_mlp.4.weight"):
        _assert_bf16_close(model.get_parameter(name).grad, grads[name], name)
    for i, j in enumerate((1, 4)):
        _assert_bf16_close(model.rna_mlp[j].bias.grad,
                           _bias_sum_rounded_once(rows[f"dense_{i}"]["bias"]),
                           f"rna_mlp.{j}.bias")


def test_patch_model_matches_flax():
    from multimodalbrainsurvival_tpu.models import (
        PatchHistopathologyRNAModel as JaxPatch,
        RNAEncoder as JaxEncoder,
    )
    from multimodalbrainsurvival_tpu.models.resnet import RESNET_CONSTRUCTORS as JR

    model = PatchHistopathologyRNAModel(
        RESNET_CONSTRUCTORS["resnet18"](num_classes=None),
        RNAEncoder(GENES, (4096, 2048), dropout=0.0), head_dropout=0.0)
    state = _random_state(model, seed=12)
    model.load_state_dict(state)
    variables = torch_joint_to_flax(_numpy_state(state))
    rng = np.random.default_rng(13)
    patch = rng.standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    rna = rng.standard_normal((3, GENES)).astype(np.float32)
    jmodel = JaxPatch(resnet=JR["resnet18"](),
                      rna_encoder=JaxEncoder(hidden_dims=(4096, 2048), dropout=0.0),
                      head_dropout=0.0)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(patch), jnp.asarray(rna),
                                   train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(patch).permute(0, 3, 1, 2),
                           torch.from_numpy(rna))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --- data ------------------------------------------------------------------------


def test_feature_table_batches_match_jax(tmp_path):
    from multimodalbrainsurvival_tpu.data import FeatureTableDataset as JaxFeatures

    path = str(tmp_path / "features.csv")
    make_survival_csv(path, [f"c{i}" for i in range(11)], n_feature=24, seed=3)
    ours, theirs = FeatureTableDataset(path), JaxFeatures(path)
    assert ours.feature_dim == theirs.feature_dim == 24
    for got, want in zip(ours.batches(4, shuffle=True, seed=5),
                         theirs.batches(4, shuffle=True, seed=5), strict=True):
        assert got["case"] == want["case"]
        for key in ("data", "mask", "survival_months", "vital_status"):
            np.testing.assert_array_equal(got[key], want[key])


@pytest.fixture(scope="module")
def joint_cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("joint_data")
    root = str(tmp / "patches")
    wsis = [f"J{i}" for i in range(4)]
    for i, w in enumerate(wsis):
        make_patch_dir(root, w, 3 + i, img_size=IMG, seed=60 + i)
    path = str(tmp / "joint.csv")
    make_survival_csv(path, ["a", "b", "c", "c"], wsi_names=[f"{w}.svs" for w in wsis],
                      n_rna=GENES, seed=4)
    return root, path


@pytest.mark.parametrize("cls_name", ["PatchBagRNADataset", "PatchRNADataset"])
def test_joint_batches_match_jax(joint_cohort, cls_name):
    """Both stacks' joint datasets after two per-epoch shuffles, in the
    shuffled order with the first batch skipped: the same bags, slides,
    masks and RNA vectors (the CSV's values as float32)."""
    from multimodalbrainsurvival_tpu.data import patches as jax_patches

    from multimodalbrainsurvival_torch import data as torch_data

    root, path = joint_cohort
    kw = dict(img_size=IMG, max_patches_total=5, seed=2)
    if cls_name == "PatchBagRNADataset":
        kw.update(bag_size=2, keep_remainder=True)
    ours = getattr(torch_data, cls_name)(root, path, **kw)
    theirs = getattr(jax_patches, cls_name)(root, path, **kw)
    assert ours.rna_dim == theirs.rna_dim == GENES
    for ds in (ours, theirs):
        ds.shuffle()
        ds.shuffle()
    frame = pd.read_csv(path)
    rna = frame[[f"rna_{i}" for i in range(GENES)]].to_numpy(np.float32)
    got_all = list(ours.batches(3, shuffle=True, seed=9, num_threads=2, skip_batches=1))
    want_all = list(theirs.batches(3, shuffle=True, seed=9, num_threads=2,
                                   skip_batches=1))
    assert len(got_all) == len(want_all) >= 1
    for got, want in zip(got_all, want_all):
        assert got["WSI"] == want["WSI"]
        keys = ["patch_bag", "bag_mask", "sample_mask", "rna_data"]
        keys += ["patch"] if cls_name == "PatchRNADataset" else []
        for key in keys:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        for i, wsi in enumerate(got["WSI"]):
            if wsi:
                np.testing.assert_array_equal(got["rna_data"][i], rna[int(wsi[1:])])


def test_joint_dataset_needs_rna_columns(tmp_path, joint_cohort):
    root, _ = joint_cohort
    path = str(tmp_path / "no_rna.csv")
    make_survival_csv(path, ["a"], wsi_names=["J0.svs"], seed=1)
    with pytest.raises(ValueError, match="rna_"):
        PatchBagRNADataset(root, path, img_size=IMG, bag_size=1)


# --- F4 ----------------------------------------------------------------------------


@pytest.fixture
def feature_sets(tmp_path):
    paths = {}
    for split, n, seed in (("train", 16, 1), ("val", 8, 2), ("test", 8, 3)):
        paths[split] = str(tmp_path / f"{split}.csv")
        make_survival_csv(paths[split], [f"{split}{i}" for i in range(n)], n_feature=12,
                          seed=seed)
    return {split: FeatureTableDataset(p) for split, p in paths.items()}


def _train(datasets, save_dir, lr, seed, **settings):
    torch.manual_seed(seed)
    model = EarlyFusionMLP(12, (16, 8), dropout=0.0)
    adapter = TableAdapter(model=model, device=torch.device("cpu"))
    optimizer = wrap_optimizer(build_grouped_optimizer(model, [("all", "", lr)]))
    outputs = train_model(adapter, datasets, optimizer, TrainSettings(
        batch_size=8, save_dir=str(save_dir), output_dir=str(save_dir / "out"), seed=seed,
        **settings))
    return model, outputs


def test_f4_a_run_without_a_best_reports_its_last_weights(feature_sets, tmp_path):
    save = tmp_path / "models"
    _train(feature_sets, save, 1e-2, seed=1, num_epochs=2)
    first_best = (save / "model_dict_best.pt").read_bytes()
    _, outputs = _train(feature_sets, save, 1e-3, seed=2, num_epochs=1, best_from_epoch=1)
    assert (save / "model_dict_best.pt").read_bytes() == first_best
    for split in ("train", "val", "test"):
        last = pd.read_csv(save / "out" / f"{split}_output_last.csv")
        best = pd.read_csv(save / "out" / f"{split}_output_best.csv")
        pd.testing.assert_frame_equal(best, last)
        assert outputs[f"{split}_metrics_best"] == outputs[f"{split}_metrics_last"]


def test_f4_a_resumed_run_keeps_its_restored_best(feature_sets, tmp_path, capsys):
    """Two epochs, then a resumed third that keeps no best of its own
    (``best_from_epoch`` past it is moot: its val loss is not lower, or it
    is and it saves): the best frames are those of the restored best
    weights whenever the third epoch did not improve."""
    save = tmp_path / "models"
    _train(feature_sets, save, 1e-2, seed=1, num_epochs=2)
    best_state = torch.load(save / "model_dict_best.pt", weights_only=True)
    capsys.readouterr()
    model, outputs = _train(feature_sets, save, 0.0, seed=1, num_epochs=3, resume=True)
    log = capsys.readouterr().out
    assert "Resumed full train state" in log and "LOADING BEST MODEL" in log
    # LR 0: the third epoch cannot beat the restored best
    assert torch.equal(torch.load(save / "model_dict_best.pt", weights_only=True)["1.weight"],
                       best_state["1.weight"])
    restored = EarlyFusionMLP(12, (16, 8), dropout=0.0)
    restored.load_state_dict(best_state)
    want = restored.eval()(torch.from_numpy(feature_sets["val"].features)).detach()
    best = pd.read_csv(save / "out" / "val_output_best.csv")
    np.testing.assert_allclose(best["score"], want[:, 0].numpy(), rtol=1e-6, atol=1e-7)
    del model, outputs
