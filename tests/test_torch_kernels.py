"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``gpu`` and
skips without a card. This file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import pytest
import torch

from multimodalbrainsurvival_torch.models.resnet import Bottleneck

from multimodalbrainsurvival_torch.kernels.attention_pool import (
    attention_pool,
    attention_pool_backward,
    attention_pool_plain,
    pool,
)
from multimodalbrainsurvival_torch.kernels.dropout_matmul import (
    DropoutMatmul,
    dropout_matmul,
    dropout_matmul_plain,
    seeded_dropout,
    seeded_dropout_pair,
    seeded_dropout_plain,
)
from multimodalbrainsurvival_torch.kernels.fused_stage import (
    fused_bottleneck_stage,
    fused_bottleneck_stage_plain,
    pack_bottleneck,
)
from multimodalbrainsurvival_torch.kernels.qmm_requant import (
    qconv_requant,
    qconv_requant_plain,
    qconv_residual_requant,
    qconv_residual_requant_plain,
    qmm_requant,
    qmm_requant_plain,
    stem_requant_pool,
    stem_requant_pool_plain,
)

# (B, bag, D, real patches per bag; None = all real)
SHAPES = {
    "serving_16x16x2048": (16, 16, 2048, None),
    "padded_and_empty_bags": (4, 6, 32, [6, 3, 0, 5]),
    "bag_1": (3, 1, 16, [1, 1, 0]),
    "d72_rows_not_tile_multiple": (3, 7, 72, [7, 4, 1]),
    "long_bag_dynamic_smem": (1, 13000, 64, None),
    "resnet18_34_d512": (8, 16, 512, [16, 9, 16, 1, 16, 16, 0, 12]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    from multimodalbrainsurvival_torch.device import configure_precision

    configure_precision()
    return torch.device("cuda")


def _inputs(name, device, seed=0):
    B, bag, D, lengths = SHAPES[name]
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, bag, D, generator=g)
    weight = torch.randn(D, D, generator=g) / D**0.5
    v = torch.randn(D, generator=g) * 0.05 * (2048 / D) ** 0.5
    if lengths is None:
        mask = torch.ones(B, bag, dtype=torch.bool)
    else:
        mask = torch.arange(bag)[None, :] < torch.tensor(lengths)[:, None]
    return tuple(t.to(device) for t in (x, weight, v, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_attention_pool_kernel_matches_plain(cuda, name, dtype):
    """The same inputs (rounded to ``dtype``) through the kernel and the
    plain float32 version; only the order of the float32 sums differs, so
    ``atol=2e-4`` bounds the softmax-amplified rounding of the logits."""
    x, weight, v, mask = _inputs(name, cuda)
    x, weight = x.to(dtype), weight.to(dtype)
    before = attention_pool.launches
    pooled, w = attention_pool(x, weight, v, mask)
    torch.cuda.synchronize()
    assert attention_pool.launches == before + 1
    want_pooled, want_w = attention_pool_plain(x, weight, v, mask)
    torch.testing.assert_close(pooled, want_pooled, rtol=0, atol=2e-4)
    torch.testing.assert_close(w, want_w, rtol=0, atol=2e-4)
    assert torch.all(pooled[~mask.any(dim=1)] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_pool_kernel_is_deterministic(cuda, dtype):
    """The cluster adds its blocks' sums in rank order and the gate sums in
    a fixed order, with no atomics: the same inputs give the same bits."""
    x, weight, v, mask = _inputs("serving_16x16x2048", cuda)
    x, weight = x.to(dtype), weight.to(dtype)
    first = attention_pool(x, weight, v, mask)
    for _ in range(3):
        again = attention_pool(x, weight, v, mask)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_attention_pool_kernel_rejects_unaligned_rows(cuda):
    """TMA needs rows of a multiple of 16 bytes: D = 12 in bfloat16 (24
    bytes) is refused, never served by another route."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 12, generator=g).to(cuda, torch.bfloat16)
    weight = torch.randn(12, 12, generator=g).to(cuda, torch.bfloat16)
    v, mask = torch.zeros(12, device=cuda), torch.ones(2, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        attention_pool(x, weight, v, mask)
    assert attention_pool(x.float(), weight.float(), v, mask)[0].shape == (2, 12)


@pytest.mark.gpu
def test_attention_pool_kernel_rejects_mixed_dtypes(cuda):
    x, weight, v, mask = _inputs("bag_1", cuda)
    with pytest.raises(ValueError, match="one dtype"):
        attention_pool(x.to(torch.bfloat16), weight, v, mask)
    with pytest.raises(ValueError, match="contiguous"):
        attention_pool(x, weight.t(), v, mask)


# K1's gradient: (B, bag, D, real patches per bag; None = all real)
GRAD_SHAPES = {
    "train_16x16x2048_padded": (16, 16, 2048, [16] + [10] + [0] + [16] * 13),
    "padded_128x2x2048": (128, 2, 2048, [2, 1, 0] + [2] * 125),
    # a bag of one patch: softmax weight 1, so dW = dv = 0 on both sides
    "reference_128x1x2048": (128, 1, 2048, None),
}
# err / max|gradient| through K1 against autograd of the plain version
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-7}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GRAD_SHAPES))
def test_attention_pool_function_gradients_match_plain_autograd(cuda, name, dtype):
    """``AttentionPool`` (K1 forward, the analytic backward) against autograd
    of the plain version on the card, with cotangents on both outputs: dx,
    dW and dv within 1e-4 (float32) or 2**-7 (bfloat16) of each gradient's
    scale; one K1 launch and one backward call; pads get no gradient."""
    B, bag, D, lengths = GRAD_SHAPES[name]
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(B, bag, D, generator=g).relu()
    weight = torch.randn(D, D, generator=g) / D**0.5
    v = torch.randn(D, generator=g) * 0.05
    mask = (torch.ones(B, bag, dtype=torch.bool) if lengths is None else
            torch.arange(bag)[None, :] < torch.tensor(lengths)[:, None])
    g_out, g_attn = torch.randn(B, D, generator=g), torch.randn(B, bag, generator=g)
    x, weight, v, mask, g_out, g_attn = (t.to(cuda) for t in (x, weight, v, mask,
                                                              g_out, g_attn))
    x, weight = x.to(dtype), weight.to(dtype)
    grads = {}
    before = attention_pool.launches, attention_pool_backward.calls
    for fn in (pool, attention_pool_plain):
        leaves = [t.clone().requires_grad_() for t in (x, weight, v)]
        torch.autograd.backward(fn(*leaves, mask), (g_out, g_attn))
        grads[fn] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    assert (attention_pool.launches, attention_pool_backward.calls) == \
        (before[0] + 1, before[1] + 1)
    for got, want in zip(grads[pool], grads[attention_pool_plain]):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= GRAD_TOL[dtype] * scale
    assert not grads[pool][0][~mask].any()


def _mil_train_step(device, seed=0):
    """One train step (ResNet-18 + attention, float32, 32 px, freeze ladder
    at 2, augmentation off) from seeded weights and bags; returns the
    model with its gradients, and the loss."""
    import numpy as np

    from multimodalbrainsurvival_torch.cli._common import build_mil_model
    from multimodalbrainsurvival_torch.config import Config
    from multimodalbrainsurvival_torch.train import TrainSettings
    from multimodalbrainsurvival_torch.train.adapters import MILAdapter
    from multimodalbrainsurvival_torch.train.loop import make_loss_fn, train_step
    from multimodalbrainsurvival_torch.train.optim import (
        build_grouped_optimizer,
        mil_freeze_ladder,
        wrap_optimizer,
    )

    torch.manual_seed(seed)
    cfg = Config({"model_name": "resnet18", "aggregator": "attention", "num_classes": 1})
    model = build_mil_model(cfg)
    with torch.no_grad():
        model.aggregator.vector.normal_(0.0, 0.2)
    model = model.to(device, memory_format=torch.channels_last)
    adapter = MILAdapter(model=model, device=device, augment=False)
    opt = wrap_optimizer(build_grouped_optimizer(
        model, [("train", mil_freeze_ladder(2), 1e-4)]))
    rng = np.random.default_rng(seed)
    batch = {"patch_bag": rng.integers(0, 256, (4, 3, 32, 32, 3), np.uint8),
             "bag_mask": np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1], [0, 0, 0]], bool),
             "sample_mask": np.array([1, 1, 1, 0], bool),
             "survival_months": np.array([10.0, 20.0, 5.0, 0.0], np.float32),
             "vital_status": np.array([1.0, 0.0, 1.0, 0.0], np.float32)}
    settings = TrainSettings(task="survival_prediction", batch_size=4)
    loss_fn, keys = make_loss_fn(settings)
    arrays = adapter.to_device(batch, adapter.array_keys + keys)
    loss = train_step(adapter, opt, loss_fn, arrays, settings,
                      torch.Generator(device=device).manual_seed(seed))
    return model, loss


@pytest.mark.gpu
def test_mil_train_step_on_the_card_sends_gradients_through_k1(cuda):
    """A train step on ``cuda`` runs K1 forward and its backward, and the
    gradient reaches the aggregator and the trainable ResNet stage (the
    kernel's outputs alone carry none): every trainable gradient is there
    and equals the same step's on the CPU within 1e-3 of its scale (cuDNN
    and oneDNN sum in other orders), the frozen stages have none."""
    before = attention_pool.launches, attention_pool_backward.calls
    model, loss = _mil_train_step(cuda)
    torch.cuda.synchronize()
    assert attention_pool.launches == before[0] + 1
    assert attention_pool_backward.calls == before[1] + 1
    ref, ref_loss = _mil_train_step(torch.device("cpu"))
    assert abs(loss.item() - ref_loss.item()) <= 1e-4 * max(1.0, abs(ref_loss.item()))
    ref_params = dict(ref.named_parameters())
    trainable = ("fc.", "aggregator.", "resnet.layer4.")
    for name, p in model.named_parameters():
        if not name.startswith(trainable):
            assert p.grad is None and not p.requires_grad, name
            continue
        assert p.grad is not None, name
        want = ref_params[name].grad
        if name == "fc.bias":
            # the Cox loss is blind to a shift of the scores: float32 noise
            assert p.grad.abs().max().item() <= 1e-5, name
            continue
        scale = want.abs().max().item()
        assert scale > 0, name
        assert (p.grad.cpu() - want).abs().max().item() <= 1e-3 * scale, name
    for name in ("aggregator.linear.weight", "aggregator.vector",
                 "resnet.layer4.1.conv2.weight"):
        assert model.get_parameter(name).grad.abs().sum() > 0, name


# K3: products (M, K, N) and convs (batch, H, W, C, N, kernel, stride, pad)
QMM_SHAPES = {
    "m_not_tile_multiple": (333, 64, 256),
    "k72_n24": (517, 72, 24),
    "deepest_k_4608": (300, 4608, 40),
    "layer4_conv3": (12544, 512, 2048),
}
QCONV_SHAPES = {
    "3x3_on_7x7_pad1": (2, 7, 7, 64, 48, 3, 1, 1),
    "3x3_stride2_pad1": (3, 9, 9, 32, 64, 3, 2, 1),
    "1x1_stride2": (2, 8, 8, 64, 128, 1, 2, 0),
    "3x3_c24_byte_gather": (2, 7, 7, 24, 16, 3, 1, 1),
}


def _q_inputs(x_shape, w_shape, device, seed=0):
    """int8 operands and a float32 epilogue whose outputs span ±127."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randint(-127, 128, x_shape, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, w_shape, generator=g, dtype=torch.int8)
    n, k = w_shape[0], w[0].numel()
    scale = (40.0 / (k**0.5 * 5376.0)) * (0.5 + torch.rand(n, generator=g))
    bias = torch.rand(n, generator=g) * 10 - 5
    return tuple(t.to(device) for t in (x, w, scale, bias))


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("name", sorted(QMM_SHAPES))
def test_qmm_requant_kernel_equals_plain(cuda, name, relu):
    """The int32 sum is exact and the epilogue rounds as the plain version
    does, so the int8 outputs are identical."""
    M, K, N = QMM_SHAPES[name]
    a, w, scale, bias = _q_inputs((M, K), (N, K), cuda)
    before = qmm_requant.launches
    out = qmm_requant(a, w, scale, bias, relu=relu)
    torch.cuda.synchronize()
    assert qmm_requant.launches == before + 1
    want = qmm_requant_plain(a, w, scale, bias, relu=relu)
    assert out.dtype == torch.int8 and out.shape == (M, N)
    assert int((out != want).sum()) == 0
    assert 0 < float((out.abs() == 127).float().mean()) < 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("name", sorted(QCONV_SHAPES))
def test_qconv_requant_kernel_equals_plain(cuda, name, relu):
    batch, H, W, C, N, k, stride, pad = QCONV_SHAPES[name]
    x, w, scale, bias = _q_inputs((batch, H, W, C), (N, k, k, C), cuda)
    out = qconv_requant(x, w, scale, bias, stride=stride, padding=pad, relu=relu)
    torch.cuda.synchronize()
    want = qconv_requant_plain(x, w, scale, bias, stride=stride, padding=pad,
                               relu=relu)
    assert out.shape == want.shape
    assert int((out != want).sum()) == 0


@pytest.mark.gpu
def test_qconv_requant_kernel_takes_a_misaligned_input(cuda):
    """An input that starts 1 byte into its storage cannot be read in
    16-byte chunks; the kernel gathers it byte by byte."""
    x, w, scale, bias = _q_inputs((1, 6, 6, 32), (32, 3, 3, 32), cuda)
    base = torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = base[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    out = qconv_requant(shifted, w, scale, bias, padding=1)
    want = qconv_requant_plain(shifted, w, scale, bias, padding=1)
    assert int((out != want).sum()) == 0


# K3's residual form: (batch, H, W, C, N, kernel, stride, pad) of the last
# conv of a block; ragged M and N (N not a multiple of 16 writes byte by
# byte), C = 24 gathers byte by byte
RESIDUAL_SHAPES = {
    "layer1_conv3_2x56x56": (2, 56, 56, 64, 256, 1, 1, 0),
    "layer4_conv3_n2048": (2, 7, 7, 512, 2048, 1, 1, 0),
    "basic_conv2_3x3": (2, 9, 9, 64, 64, 3, 1, 1),
    "ragged_m105_n40": (3, 5, 7, 32, 40, 1, 1, 0),
    "c24_byte_gather": (2, 7, 7, 24, 48, 3, 1, 1),
}


def _residual_inputs(shape, device, shift=0, seed=0):
    batch, H, W, C, N, k, stride, pad = shape
    x, w, scale, bias = _q_inputs((batch, H, W, C), (N, k, k, C), device, seed)
    if shift:  # x starting `shift` bytes into its storage
        base = torch.empty(x.numel() + shift, dtype=torch.int8, device=device)
        base[shift:].view(x.shape).copy_(x)
        x = base[shift:].view(x.shape)
    ho, wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    r = torch.randint(-127, 128, (batch, ho, wo, N), generator=g, dtype=torch.int8)
    scales = [torch.tensor(v, device=device) for v in (0.05, 0.04, 0.06)]
    return (x, w, scale, bias, r.to(device), *scales), dict(stride=stride, padding=pad)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(RESIDUAL_SHAPES))
def test_qconv_residual_requant_kernel_equals_plain(cuda, name):
    """The conv with relu off, then relu(t·s_t + r·s_r) requantized to s_out,
    all in one launch: identical to the plain version's int8."""
    args, conv = _residual_inputs(RESIDUAL_SHAPES[name], cuda)
    before = qmm_requant.launches, qconv_residual_requant.launches
    out = qconv_residual_requant(*args, **conv)
    torch.cuda.synchronize()
    assert (qmm_requant.launches, qconv_residual_requant.launches) == \
        (before[0] + 1, before[1] + 1)
    want = qconv_residual_requant_plain(*args, **conv)
    assert out.shape == want.shape and out.dtype == torch.int8
    assert int((out != want).sum()) == 0
    assert 0 < float((out == 0).float().mean()) < 0.9 and int(out.max()) > 32


@pytest.mark.gpu
def test_qconv_residual_requant_kernel_takes_a_misaligned_input(cuda):
    args, conv = _residual_inputs((1, 6, 6, 32, 32, 3, 1, 1), cuda, shift=1)
    assert args[0].data_ptr() % 16 != 0
    out = qconv_residual_requant(*args, **conv)
    want = qconv_residual_requant_plain(*args, **conv)
    assert int((out != want).sum()) == 0


# the stem pass: (batch, C, H, W) of the float32 stem conv output
STEM_SHAPES = {
    "resnet_224px_4x64x112x112": (4, 64, 112, 112),
    "odd_2x64x15x13": (2, 64, 15, 13),
    "c3_1x3x9x7": (1, 3, 9, 7),
}


@pytest.mark.gpu
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("name", sorted(STEM_SHAPES))
def test_stem_requant_pool_kernel_equals_plain(cuda, name, channels_last):
    batch, C, H, W = STEM_SHAPES[name]
    g = torch.Generator(device="cpu").manual_seed(3)
    y = (torch.randn(batch, C, H, W, generator=g) * 2).to(cuda)
    if channels_last:
        y = y.contiguous(memory_format=torch.channels_last)
    bias = (torch.randn(C, generator=g) * 0.5).to(cuda)
    s = torch.tensor(0.02, device=cuda)
    before = stem_requant_pool.launches
    out = stem_requant_pool(y, bias, s)
    torch.cuda.synchronize()
    assert stem_requant_pool.launches == before + 1
    want = stem_requant_pool_plain(y, bias, s)
    assert out.shape == want.shape == (batch, (H + 1) // 2, (W + 1) // 2, C)
    assert out.is_contiguous() and int((out != want).sum()) == 0
    assert int(out.min()) == 0 and int(out.max()) == 127


@pytest.mark.gpu
def test_qmm_requant_kernel_rejects_bad_inputs(cuda):
    a, w, scale, bias = _q_inputs((64, 32), (16, 32), cuda)
    with pytest.raises(ValueError, match="int8"):
        qmm_requant(a.float(), w, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        qmm_requant(a.t().contiguous().t(), w, scale, bias)
    x = a.view(2, 4, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        qconv_requant(x.permute(0, 2, 1, 3), w.view(16, 1, 1, 32), scale, bias)


# K2: (M, K, N) of x (M, K) and the nn.Linear-layout weight (N, K)
DM_SHAPES = {
    "rna_dense_0": (256, 12778, 4096),
    "rna_dense_1": (256, 4096, 2048),
    "ragged_37x300x65": (37, 300, 65),
    "one_row": (1, 33, 7),
    "k_not_tile_multiple": (130, 2100, 129),
    # a ragged batch at dense_0's width (8-byte cp.async route)
    "ragged_batch_100x12778x4096": (100, 12778, 4096),
    # the three load routes: rows of 1,200 bytes (K % 4 == 0: TMA), of
    # 1,204 bytes (K odd: 4-byte pieces), of 1,208 bytes (K even: 8-byte)
    "k300_1200_byte_rows": (128, 300, 256),
    "k301_odd_4_byte_route": (77, 301, 200),
    "k302_even_8_byte_route": (64, 302, 130),
}


def _dm_inputs(M, K, N, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(N, K, generator=g) / K**0.5
    grad = torch.randn(M, N, generator=g)
    return tuple(t.to(device) for t in (x, w, grad))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.0, 0.5])
@pytest.mark.parametrize("name", sorted(DM_SHAPES))
def test_dropout_matmul_kernel_matches_plain(cuda, name, p):
    """The same mask and scaled values, float32 sums over up to 12,778
    terms in another order than cuBLAS's (TF32 off): ``atol=1e-4`` on
    outputs of order 1."""
    x, w, _ = _dm_inputs(*DM_SHAPES[name], cuda)
    before = dropout_matmul.launches
    out = dropout_matmul(x, w, 20240607, p)
    torch.cuda.synchronize()
    assert dropout_matmul.launches == before + 1
    want = dropout_matmul_plain(x, w, 20240607, p)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)


# K2b's shapes: 16-byte pieces (K = 4,096; and K = 300), a scalar head of 0
# or 2 values before them on alternate rows (K = 12,778), 4-byte pieces
# behind a head of up to 3 (K = 301), and rows shorter than a piece
K2B_SHAPES = [(256, 12778), (256, 4096), (37, 300), (1, 1), (64, 301), (3, 2)]


def _shifted(x, floats):
    """A contiguous copy of ``x`` starting ``floats`` floats past a fresh
    (512-byte aligned) allocation."""
    base = torch.empty(x.numel() + floats, device=x.device)
    out = base[floats:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("shape", K2B_SHAPES)
def test_seeded_dropout_kernel_equals_plain(cuda, shape, p):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = seeded_dropout.launches
    out = seeded_dropout(x, -12345, p)
    torch.cuda.synchronize()
    assert seeded_dropout.launches == before + 1
    assert torch.equal(out, seeded_dropout_plain(x, -12345, p))


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("shape", [(256, 4096), (256, 12778), (37, 300)])
def test_seeded_dropout_kernel_takes_a_misaligned_input(cuda, shape, shift):
    """x starting 4, 8 or 12 bytes into its storage, the output fresh: the
    kernel falls to 8- or 4-byte pieces and computes the same values."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    shifted = _shifted(x, shift)
    assert shifted.data_ptr() % 16 == 4 * shift and shifted.is_contiguous()
    out = seeded_dropout(shifted, 99, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, seeded_dropout_plain(x, 99, 0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("shape", K2B_SHAPES)
def test_seeded_dropout_pair_kernel_equals_two_plain_calls(cuda, shape, p):
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn(shape, generator=g).to(cuda) for _ in range(2))
    before = (seeded_dropout.launches, seeded_dropout_pair.launches)
    out_a, out_b = seeded_dropout_pair(a, b, -12345, p)
    torch.cuda.synchronize()
    assert (seeded_dropout.launches, seeded_dropout_pair.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(out_a, seeded_dropout_plain(a, -12345, p))
    assert torch.equal(out_b, seeded_dropout_plain(b, -12345, p))


@pytest.mark.gpu
@pytest.mark.parametrize("shifts", [(0, 1), (0, 2), (2, 0), (1, 3), (3, 3)])
@pytest.mark.parametrize("shape", [(256, 4096), (256, 12778), (37, 300)])
def test_seeded_dropout_pair_kernel_takes_bases_on_different_alignments(
        cuda, shape, shifts):
    """The two inputs start 0-12 bytes past a 16-byte boundary, each its
    own: the pair takes the narrower piece of the two and computes what
    two plain calls do."""
    g = torch.Generator().manual_seed(4)
    a, b = (_shifted(torch.randn(shape, generator=g).to(cuda), s) for s in shifts)
    out_a, out_b = seeded_dropout_pair(a, b, 5, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(out_a, seeded_dropout_plain(a, 5, 0.5))
    assert torch.equal(out_b, seeded_dropout_plain(b, 5, 0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.0, 0.5])
def test_dropout_matmul_kernel_takes_a_misaligned_input(cuda, p):
    """x starting 4 bytes into its storage cannot be loaded by TMA or in
    8-byte pieces, though its rows (K = 300) would allow it: the kernel
    copies 4 bytes at a time and computes the same function."""
    x, w, _ = _dm_inputs(40, 300, 72, cuda, seed=2)
    base = torch.empty(x.numel() + 1, device=cuda)
    shifted = base[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 8 != 0 and shifted.is_contiguous()
    out = dropout_matmul(shifted, w, 5, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, dropout_matmul_plain(x, w, 5, p), rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 1000, 96), DM_SHAPES["rna_dense_0"]],
                         ids=["64x1000x96", "rna_dense_0"])
@pytest.mark.parametrize("p", [0.0, 0.5])
def test_dropout_matmul_backward_matches_plain_autograd(cuda, p, shape):
    """dx and dW of ``DropoutMatmul`` (K2a forward, one launch of K2b's
    paired form in the backward) against autograd through the plain
    version."""
    x, w, grad = _dm_inputs(*shape, cuda, seed=3)
    launched = (dropout_matmul.launches, seeded_dropout.launches,
                seeded_dropout_pair.launches)
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    DropoutMatmul.apply(tx, tw, 77, p).backward(grad)
    torch.cuda.synchronize()
    assert (dropout_matmul.launches - launched[0], seeded_dropout.launches - launched[1],
            seeded_dropout_pair.launches - launched[2]) == (1, 0, 1 if p else 0)
    px, pw = x.clone().requires_grad_(), w.clone().requires_grad_()
    dropout_matmul_plain(px, pw, 77, p).backward(grad)
    torch.testing.assert_close(tx.grad, px.grad, rtol=0, atol=1e-4)
    torch.testing.assert_close(tw.grad, pw.grad, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.0, 0.5])
def test_dropout_matmul_backward_of_a_data_input(cuda, p):
    """x needs no gradient (the first layer's input is data): the backward
    masks x alone, in one launch of K2b's single form, and dW matches
    autograd through the plain version."""
    x, w, grad = _dm_inputs(*DM_SHAPES["rna_dense_0"], cuda, seed=6)
    launched = (dropout_matmul.launches, seeded_dropout.launches,
                seeded_dropout_pair.launches)
    tw = w.clone().requires_grad_()
    DropoutMatmul.apply(x, tw, 78, p).backward(grad)
    torch.cuda.synchronize()
    assert (dropout_matmul.launches - launched[0], seeded_dropout.launches - launched[1],
            seeded_dropout_pair.launches - launched[2]) == (1, 1 if p else 0, 0)
    pw = w.clone().requires_grad_()
    dropout_matmul_plain(x, pw, 78, p).backward(grad)
    torch.testing.assert_close(tw.grad, pw.grad, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_dropout_matmul_kernel_rejects_bad_inputs(cuda):
    x, w, _ = _dm_inputs(8, 16, 4, cuda)
    with pytest.raises(ValueError, match="float32"):
        dropout_matmul(x.double(), w.double(), 1, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        dropout_matmul(x.t().contiguous().t(), w, 1, 0.5)
    with pytest.raises(ValueError, match="alias"):
        seeded_dropout(torch.zeros(2, 65537, device=cuda), 1, 0.5)
    with pytest.raises(ValueError, match="one shape"):
        seeded_dropout_pair(x, x[:, :8].contiguous(), 1, 0.5)
    with pytest.raises(ValueError, match="all inputs must be on"):
        seeded_dropout_pair(x, x.cpu(), 1, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        seeded_dropout_pair(x, x.t().contiguous().t(), 1, 0.5)


# K4: (batch, H, W, Cin, Cm, Cout = 4 Cm, blocks); block 0 has a projection
# residual when Cin != Cout, the others the identity
STAGE_SHAPES = {
    "retired_2x8x8": (2, 8, 8, 16, 8, 32, 2),
    "three_blocks_1x6x10_no_projection": (1, 6, 10, 32, 8, 32, 3),
    "ragged_tiles_3x13x11": (3, 13, 11, 32, 16, 64, 2),
    "cm24_1x5x40": (1, 5, 40, 24, 24, 96, 2),
    "layer1_2x56x56": (2, 56, 56, 64, 64, 256, 3),
    "layer2_tail_2x28x28": (2, 28, 28, 512, 128, 512, 3),
    # padded tile rows and halo rows at the image edge, with a last pass of
    # output channels that is not a multiple of 64 (96 = 64 + 32; 160 =
    # 128 + 32), identity and projection
    "cout96_edge_2x30x30": (2, 30, 30, 96, 24, 96, 2),
    "cout160_projection_edge_1x15x29": (1, 15, 29, 64, 40, 160, 2),
}
# err / max(1, max|plain|): float32 sums in another order (FMA against the
# plain version's products) stay near 1e-6; in bfloat16 both round y1, y2,
# z and the sum to bfloat16, and a sum that lands on the other side of a
# rounding moves an output by 1-2 ulps (2**-8 of its size each)
STAGE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-6}


def _stage_inputs(batch, H, W, cin, cm, cout, n_blocks, device, dtype, seed=0):
    """Seeded folded blocks (LeCun-normal weights, biases of 0.1) and a
    post-ReLU channels_last input."""
    assert cout == 4 * cm
    g = torch.Generator(device="cpu").manual_seed(seed)
    blocks = []
    for j in range(n_blocks):
        blk = Bottleneck(cin if j == 0 else cout, cm, fold_bn=True)
        with torch.no_grad():
            for p in blk.parameters():
                p.copy_(torch.randn(p.shape, generator=g)
                        * (p[0].numel() ** -0.5 if p.dim() > 1 else 0.1))
        blocks.append(pack_bottleneck(blk.to(device), dtype))
    x = torch.randn(batch, cin, H, W, generator=g).relu()
    return x.to(device, dtype).contiguous(memory_format=torch.channels_last), blocks


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(STAGE_SHAPES))
def test_fused_stage_kernel_matches_plain(cuda, name, dtype):
    x, blocks = _stage_inputs(*STAGE_SHAPES[name], cuda, dtype)
    before = fused_bottleneck_stage.launches
    out = fused_bottleneck_stage(x, blocks)
    torch.cuda.synchronize()
    assert fused_bottleneck_stage.launches == before + len(blocks)
    want = fused_bottleneck_stage_plain(x, blocks)
    assert out.shape == want.shape and out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    scale = max(1.0, want.abs().max().item())
    err = (out.float() - want.float()).abs().max().item()
    assert err <= STAGE_TOL[dtype] * scale, (err, scale)
    assert torch.isfinite(out).all() and (out > 0).float().mean() > 0.2


@pytest.mark.gpu
def test_folded_bf16_extract_on_the_card_tracks_the_stock_modules(cuda):
    """The folded bf16 encoder on the card (K4 for layer1 and layer2's tail,
    cuDNN's fused conv + bias (+ residual) + ReLU for the rest) against the
    same folded weights through the stock modules: per-sample cosine, the
    two round at other places in bfloat16."""
    from multimodalbrainsurvival_torch.models.resnet import resnet50
    from multimodalbrainsurvival_torch.models.serving import fused_folded_extract

    torch.manual_seed(0)
    net = resnet50(num_classes=None, fold_bn=True, dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.1, 0.1)
    net = net.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.randn(6, 3, 64, 64, device=cuda, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    before = fused_bottleneck_stage.launches
    with torch.inference_mode():
        got = fused_folded_extract(net, x)
        want = net.extract(x)
    assert fused_bottleneck_stage.launches == before + 6
    assert got.shape == want.shape == (6, 2048) and torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=1)
    assert cos.min().item() >= 0.999, cos


@pytest.mark.gpu
def test_folded_float32_extract_on_the_card_matches_the_stock_modules(cuda):
    """In float32 the card's folded path (K4's FMA path and cuDNN's fused
    conv + bias (+ residual) + ReLU calls, TF32 off) computes what the stock
    folded modules compute, up to the order of float32 sums."""
    from multimodalbrainsurvival_torch.models.resnet import resnet50
    from multimodalbrainsurvival_torch.models.serving import fused_folded_extract

    torch.manual_seed(0)
    net = resnet50(num_classes=None, fold_bn=True)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.1, 0.1)
    net = net.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.randn(4, 3, 64, 64, device=cuda).contiguous(
        memory_format=torch.channels_last)
    before = fused_bottleneck_stage.launches
    with torch.inference_mode():
        got = fused_folded_extract(net, x)
        want = net.extract(x)
    assert fused_bottleneck_stage.launches == before + 6
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.gpu
def test_fused_stage_kernel_rejects_bad_inputs(cuda):
    x, blocks = _stage_inputs(1, 6, 6, 16, 8, 32, 1, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        fused_bottleneck_stage(x.contiguous(), blocks)
    with pytest.raises(ValueError, match="w1"):
        fused_bottleneck_stage(x.float(), blocks)
    with pytest.raises(ValueError, match="w1"):
        fused_bottleneck_stage(torch.zeros_like(x[:, :8]).contiguous(
            memory_format=torch.channels_last), blocks)
