"""K4 (the fused folded-BN bottleneck stage) and the folded serving path,
on the CPU, against the JAX package.

The same seeded numpy weights and inputs go through both stacks; on the CPU
the K4 wrapper runs its plain version (``kernels/fused_stage.py``).

- (a) the plain stage against a chain of the JAX package's folded
  ``Bottleneck`` modules: float32 at ``atol=2e-5`` (the retired TPU
  kernel's test bound), bfloat16 at the bound stated below;
- (b) ``fused_folded_extract`` at full ResNet-50 width against JAX
  ``resnet50(fold_bn=True).extract`` on ``fold_resnet_variables`` weights,
  at the retired test's ``atol=3e-6·max(scale, 1)``;
- (c) the packed weights' product against ``F.conv2d``;
- (d) the folded converter: a round trip, and folding commutes with it;
- (e) how many K4 blocks each serving path runs per batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.kernels import fused_stage
from multimodalbrainsurvival_torch.kernels.fused_stage import (
    fused_bottleneck_stage,
    pack_bottleneck,
)
from multimodalbrainsurvival_torch.models.convert import flax_folded_to_torch
from multimodalbrainsurvival_torch.models.folding import fold_resnet_state_dict
from multimodalbrainsurvival_torch.models.quantize import quantize_mil_resnet
from multimodalbrainsurvival_torch.models.resnet import (
    RESNET_CONSTRUCTORS,
    Bottleneck,
)
from multimodalbrainsurvival_torch.models.serving import fused_folded_extract
from multimodalbrainsurvival_torch.train.adapters import (
    MILAdapter,
    QuantizedMILAdapter,
)
from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
from multimodalbrainsurvival_tpu.models.folding import fold_resnet_variables
from multimodalbrainsurvival_tpu.models.resnet import Bottleneck as JaxBottleneck
from multimodalbrainsurvival_tpu.models.resnet import resnet50 as jax_resnet50
from tests.test_torch_histo_cli import _count_k4_blocks, _random_state

# (batch, H, W, Cin, Cm, blocks); Cout = 4 Cm, and block 0 has a projection
# residual when Cin != Cout
CHAINS = {
    # the retired TPU kernel's test shape
    "retired_2x8x8_two_blocks": (2, 8, 8, 16, 8, 2),
    "three_blocks_1x6x10": (1, 6, 10, 16, 8, 3),
}
# bfloat16: the JAX modules round each conv's product to bfloat16 and then
# add the bias rounded to bfloat16 (two roundings), the port adds the float32
# bias to the float32 sum and rounds once; each of the four roundings of a
# block can so differ by an ulp (2**-8 of the value), and the chain carries
# that on. 2**-5 of the output scale bounds it with room (measured: about
# 2**-7 on both chains).
BF16_TOL = 2**-5


def _chain_params(cin, cm, n_blocks, seed=0):
    """HWIO folded block trees (LeCun-normal kernels, biases of 0.1)."""
    rng = np.random.default_rng(seed)
    cout = 4 * cm

    def conv(kh, ci, co):
        return {"kernel": (rng.normal(size=(kh, kh, ci, co)) / np.sqrt(kh * kh * ci)
                           ).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(co,))).astype(np.float32)}

    blocks = []
    for j in range(n_blocks):
        c = cin if j == 0 else cout
        p = {"conv1": conv(1, c, cm), "conv2": conv(3, cm, cm), "conv3": conv(1, cm, cout)}
        if c != cout:
            p["downsample_conv"] = conv(1, c, cout)
        blocks.append(p)
    return blocks


def _jax_chain(params, x, dtype):
    y = jnp.asarray(x, dtype)
    for p in params:
        cm = p["conv1"]["kernel"].shape[-1]
        y = JaxBottleneck(filters=cm, dtype=dtype, fold_bn=True).apply(
            {"params": p}, y, train=False)
    return np.asarray(y.astype(jnp.float32))


def _port_chain(params, x, dtype):
    blocks = []
    for p in params:
        cin, cm = p["conv1"]["kernel"].shape[-2:]
        blk = Bottleneck(cin, cm, fold_bn=True).eval()
        blk.load_state_dict(flax_folded_to_torch(p))
        blocks.append(pack_bottleneck(blk, dtype))
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)  # channels_last
    with torch.inference_mode():
        out = fused_bottleneck_stage(xt, blocks)
    return out.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_plain_stage_matches_jax_folded_blocks_f32(name):
    batch, H, W, cin, cm, n_blocks = CHAINS[name]
    params = _chain_params(cin, cm, n_blocks)
    x = np.random.default_rng(1).normal(size=(batch, H, W, cin)).astype(np.float32)
    got = _port_chain(params, x, torch.float32)
    want = _jax_chain(params, x, jnp.float32)
    assert got.shape == want.shape == (batch, H, W, 4 * cm)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_plain_stage_matches_jax_folded_blocks_bf16(name):
    batch, H, W, cin, cm, n_blocks = CHAINS[name]
    params = _chain_params(cin, cm, n_blocks)
    x = np.random.default_rng(1).normal(size=(batch, H, W, cin)).astype(np.float32)
    got = _port_chain(params, x, torch.bfloat16)
    want = _jax_chain(params, x, jnp.bfloat16)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * scale)


def test_fused_folded_extract_matches_jax_resnet50():
    """Full ResNet-50 width, two 64-px images, float32: the port's folded
    serving forward (layer1 and layer2's tail through K4's plain version)
    against the JAX package's folded ``extract``."""
    stock = jax_resnet50(dtype=jnp.float32)
    v = fold_resnet_variables(
        stock.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_resnet50(dtype=jnp.float32, fold_bn=True).apply(
        v, x, train=False, method="extract"))
    model = RESNET_CONSTRUCTORS["resnet50"](fold_bn=True).eval()
    model.load_state_dict(flax_folded_to_torch(jax.tree.map(np.asarray, v)))
    with torch.inference_mode():
        got = fused_folded_extract(model, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    scale = float(np.abs(want).max())
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-6 * max(scale, 1.0))


@pytest.mark.parametrize("conv, weight", [("conv1", "w1"), ("conv2", "w2"),
                                           ("conv3", "w3"), ("downsample", "wd")])
def test_packed_weights_product_equals_conv2d(conv, weight):
    """Each packed (N, kh·kw·C) weight times the (dy, dx, c) columns of the
    zero-padded input is the block's convolution (1×1, and the 3×3)."""
    g = torch.Generator().manual_seed(2)
    blk = Bottleneck(24, 8, fold_bn=True)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    module = blk.downsample[0] if conv == "downsample" else getattr(blk, conv)
    packed = getattr(pack_bottleneck(blk, torch.float32), weight)
    k = module.kernel_size[0]
    x = torch.randn(2, module.in_channels, 7, 9, generator=g)
    assert packed.shape == (module.out_channels, k * k * module.in_channels)
    cols = fused_stage.im2col(x.permute(0, 2, 3, 1), k, k, 1, k // 2)
    got = (cols @ packed.t()).reshape(2, 7, 9, -1).permute(0, 3, 1, 2)
    want = F.conv2d(x, module.weight, padding=k // 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_pack_bottleneck_rejects_unfolded_and_strided_blocks():
    with pytest.raises(ValueError, match="folded"):
        pack_bottleneck(Bottleneck(64, 16), torch.float32)
    with pytest.raises(ValueError, match="stride-1"):
        pack_bottleneck(Bottleneck(64, 16, stride=2, fold_bn=True), torch.float32)


def _mil(arch, fold_bn, seed=0):
    """A MIL model (attention aggregator) with seeded reference weights,
    folded as ``load_mil_model`` folds them."""
    config = Config({"model_name": arch, "aggregator": "attention"})
    state = _random_state(build_mil_model(config), seed)
    model = build_mil_model(config, fold_bn=fold_bn)
    model.load_state_dict(fold_resnet_state_dict(state) if fold_bn else state)
    return model.to(memory_format=torch.channels_last).eval(), state


def test_folded_converter_round_trip():
    """port folded state → the JAX package's ``torch_mil_to_flax`` →
    ``flax_folded_to_torch``: the same tensors; and folding commutes with
    the conversion (port fold vs JAX ``fold_resnet_variables``)."""
    model, state = _mil("resnet50", True)
    folded = {k: v.numpy() for k, v in model.state_dict().items()}
    back = flax_folded_to_torch(torch_mil_to_flax(folded)["params"])
    assert set(back) == set(folded)
    for k, v in folded.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    jax_folded = fold_resnet_variables(
        torch_mil_to_flax({k: v.numpy() for k, v in state.items()}))
    via_jax = flax_folded_to_torch(jax.tree.map(np.asarray, jax_folded))
    for k, v in folded.items():
        np.testing.assert_allclose(via_jax[k].numpy(), v, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="not a folded tree"):
        flax_folded_to_torch(torch_mil_to_flax({k: v.numpy() for k, v in state.items()}))


def _batch(seed=0, img=32):
    rng = np.random.default_rng(seed)
    bags = rng.integers(0, 256, (2, 3, img, img, 3), dtype=np.uint8)
    mask = np.array([[True, True, True], [True, False, False]])
    return {"patch_bag": bags, "bag_mask": mask, "sample_mask": np.array([True, True])}


@pytest.mark.parametrize("case, per_batch", [
    ("resnet50_folded", 6),    # layer1's 3 blocks + layer2's 3 stride-1 blocks
    ("resnet101_folded", 6),   # the same stages (3 and 4 blocks)
    ("resnet50_unfolded", 0),
    ("resnet18_folded", 0),    # BasicBlocks: no bottleneck chain
    ("resnet50_int8", 0),      # K3 serves it; calibration runs the stock forward
])
def test_k4_blocks_per_batch(case, per_batch):
    arch, mode = case.split("_")
    model, _ = _mil(arch, mode != "unfolded")
    batch = _batch()
    device = torch.device("cpu")
    with _count_k4_blocks() as calls:
        if mode == "int8":
            qtree = quantize_mil_resnet(model.resnet, [batch["patch_bag"]], arch=arch)
            adapter = QuantizedMILAdapter(model=model, device=device, qtree=qtree,
                                          arch=arch)
        else:
            adapter = MILAdapter(model=model, device=device)
        arrays = adapter.to_device(batch, adapter.array_keys)
        for _ in range(2):
            out = adapter.apply(arrays)
    assert torch.isfinite(out).all()
    assert len(calls) == 2 * per_batch


def test_fused_extract_repacks_changed_weights_and_matches_stock():
    """Packed weights are cached per model; a ``load_state_dict`` (or any
    in-place change) packs them again. Both times the features are the
    stock folded ``extract``'s."""
    model, _ = _mil("resnet50", True)
    other, _ = _mil("resnet50", True, seed=5)
    resnet = model.resnet
    key = ("layer1", 0, torch.float32, torch.device("cpu"))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        torch.testing.assert_close(fused_folded_extract(resnet, x), resnet.extract(x),
                                   rtol=1e-5, atol=1e-5)
        first = resnet._fused_stage_packs[key]
        resnet.load_state_dict(other.resnet.state_dict())
        got = fused_folded_extract(resnet, x)
        assert resnet._fused_stage_packs[key] is not first
        torch.testing.assert_close(got, other.resnet.extract(x), rtol=1e-5, atol=1e-5)


def test_fused_folded_extract_takes_only_folded_bottlenecks():
    x = torch.zeros(1, 3, 32, 32)
    for arch, fold in (("resnet18", True), ("resnet50", False)):
        with pytest.raises(ValueError, match="fold_bn=True Bottleneck"):
            fused_folded_extract(RESNET_CONSTRUCTORS[arch](fold_bn=fold), x)
