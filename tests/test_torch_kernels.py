"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``gpu`` and
skips without a card. This file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import pytest
import torch

from multimodalbrainsurvival_torch.kernels.attention_pool import (
    attention_pool,
    attention_pool_plain,
)

# (B, bag, D, real patches per bag; None = all real)
SHAPES = {
    "serving_16x16x2048": (16, 16, 2048, None),
    "padded_and_empty_bags": (4, 6, 32, [6, 3, 0, 5]),
    "bag_1": (3, 1, 16, [1, 1, 0]),
    "d72_rows_not_tile_multiple": (3, 7, 72, [7, 4, 1]),
    "long_bag_dynamic_smem": (1, 13000, 64, None),
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
def test_attention_pool_kernel_rejects_mixed_dtypes(cuda):
    x, weight, v, mask = _inputs("bag_1", cuda)
    with pytest.raises(ValueError, match="one dtype"):
        attention_pool(x.to(torch.bfloat16), weight, v, mask)
    with pytest.raises(ValueError, match="contiguous"):
        attention_pool(x, weight.t(), v, mask)
