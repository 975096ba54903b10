"""K2 (seeded dropout-matmul) on the CPU: the plain versions and the
autograd function against a numpy transcription of the TPU kernel's mask
and against JAX.

The mask is held exactly against ``_mask_block`` of the retired Pallas
kernel (``multimodalbrainsurvival_tpu/ops/pallas/dropout_matmul.py:52-71``
at ``4fbc57a^``), transcribed below in numpy ``uint32`` block by block, at
the kernel's own blocks (128 × 2048). The products are held against
``jax.grad`` of ``(M⊙x)·s @ W + b`` with the same mask at ``rtol=1e-5``
(float32 sums in another order). The CUDA kernels themselves are held
against these plain versions on the card (``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.kernels.dropout_matmul import (
    DropoutMatmul,
    dropout_matmul,
    dropout_matmul_plain,
    keep_mask,
    keep_scale,
    seeded_dropout,
    seeded_dropout_pair,
    seeded_dropout_pair_plain,
    seeded_dropout_plain,
)
from multimodalbrainsurvival_torch.kernels import dropout_matmul as dm

BM, BK = 128, 2048  # the TPU kernel's blocks


def _mask_block_numpy(M, K, seed, p):
    """``_mask_block`` over the (i, k) blocks of an (M, K) input."""
    threshold = np.uint32(min(int(p * (1 << 32)), (1 << 32) - 1))
    seed32 = np.array([seed], np.int32).astype(np.uint32)
    keep = np.zeros((-(-M // BM) * BM, -(-K // BK) * BK), bool)
    r = np.arange(BM, dtype=np.uint32)[:, None]
    c = np.arange(BK, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        for i in range(keep.shape[0] // BM):
            for k in range(keep.shape[1] // BK):
                gidx = (np.uint32(i) * np.uint32(BM) + r) * np.uint32(1 << 16) + (
                    np.uint32(k) * np.uint32(BK) + c)
                h = gidx ^ (seed32 * np.uint32(0x9E3779B1))
                h = h ^ (h >> np.uint32(16))
                h = h * np.uint32(0x85EBCA6B)
                h = h ^ (h >> np.uint32(13))
                h = h * np.uint32(0xC2B2AE35)
                h = h ^ (h >> np.uint32(16))
                keep[i * BM:(i + 1) * BM, k * BK:(k + 1) * BK] = h >= threshold
    return keep[:M, :K]


@pytest.mark.parametrize("seed", [0, 1, 977, 2**31 - 1, -7])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9])
def test_plain_mask_equals_the_tpu_kernels_mask(p, seed):
    """Ragged M and K, across block edges in both axes."""
    M, K = 131, 2055
    want = _mask_block_numpy(M, K, seed, p)
    got = keep_mask(M, K, seed, p).numpy()
    np.testing.assert_array_equal(got, want)
    if p == 0:
        assert got.all()


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_and_scaling(p):
    """About 1 − p of the values kept (within 5 binomial sigmas), each one
    ``x·float32(1/(1−p))`` exactly, the rest exactly 0."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256, 3000)).astype(np.float32))
    y = seeded_dropout_plain(x, 12345, p)
    keep = keep_mask(*x.shape, 12345, p)
    n = x.numel()
    assert abs(keep.sum().item() - n * (1 - p)) < 5 * np.sqrt(n * p * (1 - p))
    torch.testing.assert_close(y[keep], x[keep] * torch.tensor(keep_scale(p)), rtol=0, atol=0)
    assert torch.all(y[~keep] == 0)
    assert not torch.equal(keep, keep_mask(*x.shape, 12346, p))


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(N, K)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("shape", [(8, 16, 4096), (37, 300, 65)])
def test_plain_product_at_p0_matches_the_jax_dense(shape):
    """p = 0: the RNA encoder's Dense of the JAX package (flax ``nn.Dense``)
    on the same weights."""
    from multimodalbrainsurvival_tpu.models.rna import RNAEncoder as JaxEncoder

    M, K, N = shape
    x, w, b, _ = _inputs(M, K, N)
    enc = JaxEncoder(hidden_dims=(N,), dropout=0.0)
    want = enc.apply({"params": {"dense_0": {"kernel": w.T, "bias": b}}}, jnp.asarray(x))
    got = dropout_matmul_plain(torch.from_numpy(x), torch.from_numpy(w), 5, 0.0) + torch.from_numpy(b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(8, 16, 4096), (37, 300, 65), (130, 2100, 9)])
def test_autograd_matches_jax_grad_with_the_same_mask(shape, p):
    """Forward, dx and dW of ``DropoutMatmul`` against ``jax.grad`` of
    ``(M⊙x)·s @ W + b`` with the transcribed mask."""
    M, K, N = shape
    x, w, b, g = _inputs(M, K, N, seed=1)
    seed = 4242
    mask = _mask_block_numpy(M, K, seed, p)
    scale = keep_scale(p)

    def f(x, w, b):
        xm = jnp.where(mask, x * scale, 0.0) if p else x
        return xm @ w.T + b

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_dx, want_dw, _ = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = DropoutMatmul.apply(tx, tw, seed, p) + torch.from_numpy(b)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [0.3, 0.5])
def test_backward_regenerates_the_forward_mask(p):
    """dx is zero exactly where the forward dropped x, and dx, dW and y are
    the plain mask's products bit for bit."""
    x, w, _, g = _inputs(64, 700, 33, seed=2)
    x, w, g = map(torch.from_numpy, (x, w, g))
    seed = 99
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = DropoutMatmul.apply(tx, tw, seed, p)
    y.backward(g)
    keep = keep_mask(64, 700, seed, p)
    assert torch.all(tx.grad[~keep] == 0) and torch.all(tx.grad[keep] != 0)
    assert torch.equal(y, seeded_dropout_plain(x, seed, p) @ w.t())
    assert torch.equal(tx.grad, seeded_dropout_plain(g @ w, seed, p))
    assert torch.equal(tw.grad, g.t() @ seeded_dropout_plain(x, seed, p))


def test_data_input_gets_no_gradient():
    """The first layer's input is data: no dx is computed, dW is."""
    x, w, _, g = _inputs(8, 20, 5)
    tw = torch.from_numpy(w).requires_grad_()
    calls = []
    orig = DropoutMatmul.backward

    def spy(ctx, grad):
        calls.append(ctx.needs_input_grad[:2])
        out = orig(ctx, grad)
        assert out[0] is None
        return out

    DropoutMatmul.backward = staticmethod(spy)
    try:
        DropoutMatmul.apply(torch.from_numpy(x), tw, 3, 0.5).backward(torch.from_numpy(g))
    finally:
        DropoutMatmul.backward = staticmethod(orig)
    assert calls == [(False, True)] and tw.grad is not None


def test_wrappers_take_the_plain_version_on_the_cpu_and_check_inputs():
    x, w, _, _ = _inputs(8, 20, 5)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    before = (dropout_matmul.launches, seeded_dropout.launches)
    assert torch.equal(dropout_matmul(x, w, 7, 0.5), dropout_matmul_plain(x, w, 7, 0.5))
    assert torch.equal(seeded_dropout(x, 7, 0.5), seeded_dropout_plain(x, 7, 0.5))
    assert seeded_dropout(x, 7, 0.0) is x
    assert (dropout_matmul.launches, seeded_dropout.launches) == before
    with pytest.raises(ValueError, match="float32"):
        dropout_matmul(x.double(), w.double(), 7, 0.5)
    with pytest.raises(ValueError, match="alias"):
        seeded_dropout(torch.zeros(1, 65537), 7, 0.5)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        seeded_dropout(x, 7, 1.0)
    with pytest.raises(ValueError, match="weight"):
        dropout_matmul(x, w.t().contiguous(), 7, 0.5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        seeded_dropout(x.to("meta"), 7, 0.5)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("shape", [(131, 2055), (129, 4097), (1, 1), (37, 300)])
def test_pair_plain_is_two_plain_calls_with_the_tpu_kernels_mask(shape, p):
    """The paired form's plain version is ``seeded_dropout_plain`` of each
    tensor, bit for bit, under ``_mask_block``'s mask: ragged shapes across
    the TPU kernel's 128 × 2048 blocks."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(2))
    seed = 31337
    out_a, out_b = seeded_dropout_pair_plain(a, b, seed, p)
    assert torch.equal(out_a, seeded_dropout_plain(a, seed, p))
    assert torch.equal(out_b, seeded_dropout_plain(b, seed, p))
    keep = torch.from_numpy(_mask_block_numpy(*shape, seed, p))
    scale = torch.tensor(keep_scale(p))
    for x, out in ((a, out_a), (b, out_b)):
        assert torch.equal(out, torch.where(keep, x * scale, torch.zeros(())))


def test_pair_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    """On the CPU the pair is its plain version with no launch counted; at
    p = 0 it returns its inputs; it refuses what the kernel does not take."""
    x, w, _, g = _inputs(8, 20, 5)
    a, b = torch.from_numpy(x), torch.from_numpy(x[::-1].copy())
    before = (seeded_dropout.launches, seeded_dropout_pair.launches)
    got = seeded_dropout_pair(a, b, 7, 0.5)
    want = seeded_dropout_pair_plain(a, b, 7, 0.5)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    pa, pb = seeded_dropout_pair(a, b, 7, 0.0)
    assert pa is a and pb is b
    assert (seeded_dropout.launches, seeded_dropout_pair.launches) == before
    with pytest.raises(ValueError, match="one shape"):
        seeded_dropout_pair(a, b[:, :-1].contiguous(), 7, 0.5)
    with pytest.raises(ValueError, match="one shape"):
        seeded_dropout_pair(a, b.reshape(-1), 7, 0.5)
    with pytest.raises(ValueError, match="float32"):
        seeded_dropout_pair(a, b.double(), 7, 0.5)
    with pytest.raises(ValueError, match="float32"):
        seeded_dropout_pair(a.half(), b.half(), 7, 0.5)
    with pytest.raises(ValueError, match="all inputs must be on cpu"):
        seeded_dropout_pair(a, b.to("meta"), 7, 0.5)
    with pytest.raises(ValueError, match="alias"):
        seeded_dropout_pair(torch.zeros(1, 65537), torch.zeros(1, 65537), 7, 0.5)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        seeded_dropout_pair(a, b, 7, 1.0)


@pytest.mark.parametrize("x_needs_grad", [True, False], ids=["dx_and_dw", "dw_only"])
def test_backward_masks_both_tensors_in_one_pair_call(monkeypatch, x_needs_grad):
    """An inner layer's backward masks g·W and x through one call of the
    paired form; the first layer's (x is data) masks x through the single
    form; the gradients are the plain mask's products bit for bit."""
    x, w, _, g = _inputs(16, 300, 9, seed=4)
    x, w, g = map(torch.from_numpy, (x, w, g))
    calls = []

    def spy(name):
        fn = getattr(dm, name)

        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    for name in ("seeded_dropout", "seeded_dropout_pair"):
        monkeypatch.setattr(dm, name, spy(name))
    tx = x.clone().requires_grad_(x_needs_grad)
    tw = w.clone().requires_grad_()
    DropoutMatmul.apply(tx, tw, 21, 0.5).backward(g)
    assert calls == (["seeded_dropout_pair"] if x_needs_grad else ["seeded_dropout"])
    assert torch.equal(tw.grad, g.t() @ seeded_dropout_plain(x, 21, 0.5))
    if x_needs_grad:
        assert torch.equal(tx.grad, seeded_dropout_plain(g @ w, 21, 0.5))
