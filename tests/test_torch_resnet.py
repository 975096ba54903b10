"""The port's ResNet encoder, BN folding, MIL model and weight converters
against the JAX package, on the CPU in float32.

Weights are made once in the JAX package, randomized (BatchNorm statistics
and affine, the attention vector) in the port's ``state_dict`` and carried
back with the JAX package's ``torch_mil_to_flax``, so both stacks hold the
same numbers. ``rtol=1e-4``, ``atol=1e-5``: float32 convolutions in two
libraries sum in different orders through up to 50 layers.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.models.aggregators import make_aggregator
from multimodalbrainsurvival_torch.models.convert import flax_mil_to_torch
from multimodalbrainsurvival_torch.models.folding import fold_resnet_state_dict
from multimodalbrainsurvival_torch.models.mil import AggregationModel
from multimodalbrainsurvival_torch.models.resnet import RESNET_CONSTRUCTORS
from multimodalbrainsurvival_torch.ops.image import preprocess_patches
from multimodalbrainsurvival_tpu.models import aggregators as jax_agg
from multimodalbrainsurvival_tpu.models import mil as jax_mil
from multimodalbrainsurvival_tpu.models import resnet as jax_resnet
from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
from multimodalbrainsurvival_tpu.models.folding import fold_resnet_variables
from multimodalbrainsurvival_tpu.ops.image import preprocess_patches as jax_preprocess

TOL = dict(rtol=1e-4, atol=1e-5)
B, BAG = 2, 3


def _jax_model(arch, fold_bn=False):
    resnet = jax_resnet.RESNET_CONSTRUCTORS[arch](fold_bn=fold_bn)
    return jax_mil.AggregationModel(
        resnet=resnet,
        aggregator=jax_agg.TanhAttention(dim=resnet.feature_dim),
        out_features=1,
    )


def _randomize(state, seed):
    """Non-trivial BN statistics and affine and a non-zero attention vector,
    so eval BN, folding and the softmax are exercised for real."""
    rng = np.random.default_rng(seed)
    bn_scopes = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_var")}
    out = dict(state)
    for k, v in state.items():
        scope, leaf = k.rsplit(".", 1)
        if scope in bn_scopes and leaf in ("weight", "running_var"):
            out[k] = torch.tensor(rng.uniform(0.5, 1.5, v.shape), dtype=v.dtype)
        elif scope in bn_scopes and leaf in ("bias", "running_mean"):
            out[k] = torch.tensor(rng.normal(0.0, 0.1, v.shape), dtype=v.dtype)
    out["aggregator.vector"] = torch.tensor(
        rng.normal(0.0, 0.5, state["aggregator.vector"].shape), dtype=torch.float32
    )
    return out


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def weights(request):
    """(arch, port state_dict, JAX variables) holding the same numbers."""
    arch = request.param
    x = jnp.zeros((B, BAG, 32, 32, 3))
    mask = jnp.ones((B, BAG), bool)
    variables = _jax_model(arch).init(jax.random.PRNGKey(0), x, mask=mask)
    np_vars = jax.tree.map(np.asarray, variables)
    state = _randomize(
        flax_mil_to_torch(np_vars["params"], np_vars["batch_stats"]), seed=3
    )
    flax_vars = torch_mil_to_flax({k: v.numpy() for k, v in state.items()})
    return arch, state, jax.tree.map(jnp.asarray, flax_vars)


def _port_model(arch, state, fold_bn=False):
    resnet = RESNET_CONSTRUCTORS[arch](num_classes=None, fold_bn=fold_bn)
    model = AggregationModel(resnet, make_aggregator("attention", resnet.feature_dim))
    model.load_state_dict(fold_resnet_state_dict(state) if fold_bn else state)
    return model.eval()


def _bags(size, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, BAG, size, size, 3)).astype(np.float32)
    mask = np.array([[True, True, True], [True, False, False]])
    return x, mask


def _port_run(model, x, mask):
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        feats = model.patch_features(xt)
        pooled, attn = model.extract_from_feats(feats, torch.from_numpy(mask))
        scores = model.fc(pooled)
    return feats.numpy(), pooled.numpy(), attn.numpy(), scores.numpy()


def _jax_run(model, variables, x, mask):
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    feats = model.apply(variables, xj.reshape((-1,) + x.shape[2:]),
                        method=lambda m, y: m.resnet.extract(y))
    pooled, attn = model.apply(variables, xj, mask=mj, method="extract")
    scores, _ = model.apply(variables, xj, mask=mj)
    return (np.asarray(feats).reshape(B, BAG, -1), np.asarray(pooled),
            np.asarray(attn), np.asarray(scores))


@pytest.mark.parametrize("size", [32, 33])
def test_extract_eval_bn_matches_jax(weights, size):
    """Eval-mode BatchNorm encoder, attention pool and head; 33 px checks
    the paddings at odd sizes (flax's SAME 1x1 stride-2 downsample)."""
    arch, state, variables = weights
    x, mask = _bags(size)
    got = _port_run(_port_model(arch, state), x, mask)
    want = _jax_run(_jax_model(arch), variables, x, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_fold_bn_matches_jax_folded_and_unfolded(weights):
    arch, state, variables = weights
    x, mask = _bags(32, seed=6)
    got = _port_run(_port_model(arch, state, fold_bn=True), x, mask)
    want_fold = _jax_run(_jax_model(arch, fold_bn=True),
                         fold_resnet_variables(variables), x, mask)
    want = _jax_run(_jax_model(arch), variables, x, mask)
    for g, wf, w in zip(got, want_fold, want):
        np.testing.assert_allclose(g, wf, **TOL)
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("size", [32, 17])
def test_preprocess_matches_jax_eval_path(size):
    rng = np.random.default_rng(size)
    imgs = rng.integers(0, 256, size=(3, size, size, 3), dtype=np.uint8)
    got = preprocess_patches(torch.from_numpy(imgs))
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jax_preprocess(jnp.asarray(imgs), train=False))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


def test_extract_rejects_wrong_channel_count():
    model = RESNET_CONSTRUCTORS["resnet18"](in_channels=4)
    with pytest.raises(ValueError, match="in_channels=4"):
        model.extract(torch.zeros(1, 3, 32, 32))


def test_aggregation_project_model_matches_jax():
    """``project → tanh`` between the pool and the head; eval-mode dropout is
    the identity in both stacks."""
    from multimodalbrainsurvival_torch.models.mil import AggregationProjectModel

    jax_model = jax_mil.AggregationProjectModel(
        resnet=jax_resnet.resnet18(),
        aggregator=jax_agg.TanhAttention(dim=512), out_features=1, hdim=24,
    )
    x, mask = _bags(32, seed=8)
    variables = jax_model.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               mask=jnp.asarray(mask))
    np_vars = jax.tree.map(np.asarray, variables)
    state = _randomize(
        flax_mil_to_torch(np_vars["params"], np_vars["batch_stats"]), seed=9)
    variables = jax.tree.map(jnp.asarray, torch_mil_to_flax(
        {k: v.numpy() for k, v in state.items()}))
    resnet = RESNET_CONSTRUCTORS["resnet18"](num_classes=None)
    model = AggregationProjectModel(
        resnet, make_aggregator("attention", 512), out_features=1, hdim=24)
    model.load_state_dict(state)
    model.eval()
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        emb, attn = model.extract(xt, torch.from_numpy(mask))
        scores, _ = model(xt, torch.from_numpy(mask))
    want_emb, want_attn = jax_model.apply(variables, jnp.asarray(x),
                                          mask=jnp.asarray(mask), method="extract")
    want_scores, _ = jax_model.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask))
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), **TOL)


@pytest.mark.parametrize("in_channels", [1, 3, 4])
@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50", "resnet101",
                                  "resnet152"])
def test_architecture_matches_jax_tree(arch, in_channels):
    """Every depth and input width: the JAX model's variable tree (shapes
    only, no compute) converts into a state_dict that loads strictly into the
    port's model, tensor for tensor."""
    resnet = jax_resnet.RESNET_CONSTRUCTORS[arch](in_channels=in_channels)
    jax_model = jax_mil.AggregationModel(
        resnet=resnet, aggregator=jax_agg.TanhAttention(dim=resnet.feature_dim))
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 1, 32, 32, in_channels)),
                               mask=jnp.ones((1, 1), bool)))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    state = flax_mil_to_torch(zeros["params"], zeros["batch_stats"])
    port = RESNET_CONSTRUCTORS[arch](num_classes=None, in_channels=in_channels)
    model = AggregationModel(port, make_aggregator("attention", port.feature_dim))
    want = model.state_dict()
    assert set(state) == set(want)
    assert all(state[k].shape == want[k].shape for k in want)
    model.load_state_dict(state)


@pytest.mark.parametrize("in_channels", [1, 4])
def test_rnone_rnfour_and_conv1_surgery_match_jax(tmp_path, in_channels):
    """A seeded 3-channel encoder through ``convert_checkpoint --arch resnet
    --in_channels`` in both stacks: conv1 equal bit for bit (the mean over
    RGB, or RGB and the JAX draw for the 4th channel), every other tensor
    unchanged; then the ``rnone`` / ``rnfour`` encoders on those weights
    match."""
    from multimodalbrainsurvival_torch.cli import convert_checkpoint
    from multimodalbrainsurvival_torch.models.convert import adapt_conv1_channels
    from multimodalbrainsurvival_torch.models.resnet import rnfour, rnone
    from multimodalbrainsurvival_tpu.cli import convert_checkpoint as jax_convert
    from multimodalbrainsurvival_tpu.models.convert import (
        adapt_conv1_channels as jax_adapt,
        torch_resnet_to_flax,
    )

    from tests.test_torch_histo_cli import _random_state

    state = _random_state(RESNET_CONSTRUCTORS["resnet18"](), seed=in_channels)
    w = state["conv1.weight"].numpy()
    torch.save(state, str(tmp_path / "rgb.pt"))
    convert_checkpoint.main(["--torch_path", str(tmp_path / "rgb.pt"), "--arch", "resnet",
                             "--output", str(tmp_path / "port.pt"), "--in_channels",
                             str(in_channels), "--device", "cpu"])
    got = torch.load(str(tmp_path / "port.pt"), weights_only=True)
    want = jax_convert.convert(str(tmp_path / "rgb.pt"), "resnet", str(tmp_path / "jax"),
                               in_channels)
    want_conv1 = np.asarray(want["params"]["conv1"]["kernel"]).transpose(3, 2, 0, 1)
    assert got["conv1.weight"].shape == (64, in_channels, 7, 7)
    np.testing.assert_array_equal(got["conv1.weight"].numpy(), want_conv1)
    np.testing.assert_array_equal(
        adapt_conv1_channels(w, in_channels),
        jax_adapt(w.transpose(2, 3, 1, 0), in_channels).transpose(3, 2, 0, 1))
    assert all(torch.equal(got[k], v) for k, v in state.items()
               if k != "conv1.weight" and not k.startswith("fc."))

    port = (rnone if in_channels == 1 else rnfour)("resnet18", num_classes=None)
    port.load_state_dict(got)
    assert port.in_channels == in_channels
    flax = (jax_resnet.rnone if in_channels == 1 else jax_resnet.rnfour)("resnet18")
    variables = jax.tree.map(jnp.asarray, torch_resnet_to_flax(
        {k: v.numpy() for k, v in state.items()}, in_channels=in_channels))
    x = np.random.default_rng(9).normal(size=(2, 32, 32, in_channels)).astype(np.float32)
    with torch.no_grad():
        feats = port.eval().extract(torch.from_numpy(x).permute(0, 3, 1, 2))
    want_feats = flax.apply(variables, jnp.asarray(x), method="extract")
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), **TOL)
    with pytest.raises(ValueError, match="Cannot adapt"):
        adapt_conv1_channels(w, 2)
    for path in ("rgb.pt", "port.pt"):  # the suite's disk is shared
        (tmp_path / path).unlink()
    shutil.rmtree(tmp_path / "jax")
