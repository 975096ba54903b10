"""The port's gated-attention pool against the JAX package.

The oracle is the live JAX composition ``TanhAttention`` +
``masked_bag_mean`` (``models/aggregators.py:52-73``, ``models/mil.py:22-28``)
that the retired TPU kernel computed. On the CPU the port's wrapper takes
its plain version, so these tests hold that version and the port's
aggregator modules to the oracle, f32, ``atol=1e-5``. The CUDA kernel itself
is held to the plain version on the card by ``tests/test_torch_kernels.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.kernels.attention_pool import (
    attention_pool,
    attention_pool_plain,
)
from multimodalbrainsurvival_torch.models.aggregators import (
    IdentityAggregator,
    TanhAttention,
)
from multimodalbrainsurvival_tpu.models.aggregators import (
    IdentityAggregator as JaxIdentityAggregator,
    TanhAttention as JaxTanhAttention,
)
from multimodalbrainsurvival_tpu.models.mil import masked_bag_mean

# (B, bag, D, real patches per bag)
CASES = {
    "padded_bags": (4, 6, 32, [6, 3, 1, 5]),
    "all_masked_row": (3, 5, 16, [5, 0, 2]),
    "bag_1": (3, 1, 16, [1, 1, 0]),
    "d72": (2, 7, 72, [7, 4]),
}


def _inputs(case, seed=0):
    B, bag, D, lengths = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, bag, D)).astype(np.float32)
    kernel = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)  # h = x @ kernel
    v = rng.normal(size=(D,)).astype(np.float32)
    mask = np.arange(bag)[None, :] < np.asarray(lengths)[:, None]
    return x, kernel, v, mask


def _jax_pool(x, kernel, v, mask):
    agg = JaxTanhAttention(dim=x.shape[-1])
    variables = {"params": {"vector": jnp.asarray(v),
                            "linear": {"kernel": jnp.asarray(kernel)}}}
    out, weights = agg.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask))
    return np.asarray(masked_bag_mean(out, jnp.asarray(mask))), np.asarray(weights)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pool_matches_jax_composition(case):
    x, kernel, v, mask = _inputs(case)
    want_pooled, want_w = _jax_pool(x, kernel, v, mask)
    pooled, w = attention_pool_plain(
        torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
        torch.from_numpy(v), torch.from_numpy(mask),
    )
    np.testing.assert_allclose(pooled.numpy(), want_pooled, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), want_w, rtol=0, atol=1e-5)
    # an all-masked (padded-sample) bag pools to zeros with zero weights
    empty = ~mask.any(axis=1)
    assert np.all(pooled.numpy()[empty] == 0) and np.all(w.numpy()[empty] == 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tanh_attention_module_matches_jax(case):
    """The aggregator module through the wrapper's CPU dispatch: no kernel
    launch is counted on the CPU."""
    x, kernel, v, mask = _inputs(case, seed=1)
    want_pooled, want_w = _jax_pool(x, kernel, v, mask)
    agg = TanhAttention(dim=x.shape[-1])
    agg.load_state_dict({"linear.weight": torch.from_numpy(kernel.T.copy()),
                         "vector": torch.from_numpy(v)})
    before = attention_pool.launches
    pooled, w = agg(torch.from_numpy(x), torch.from_numpy(mask))
    assert attention_pool.launches == before
    np.testing.assert_allclose(pooled.detach().numpy(), want_pooled, atol=1e-5)
    np.testing.assert_allclose(w.detach().numpy(), want_w, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_identity_aggregator_matches_jax(case):
    x, _, _, mask = _inputs(case, seed=2)
    out, want_w = JaxIdentityAggregator().apply({}, jnp.asarray(x),
                                                mask=jnp.asarray(mask))
    want = np.asarray(masked_bag_mean(out, jnp.asarray(mask)))
    pooled, w = IdentityAggregator()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(pooled.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("bad", ["weight_shape", "v_shape", "mask_dtype",
                                 "mask_shape", "rank", "empty_bag"])
def test_wrapper_rejects_malformed_inputs(bad):
    x, W, v = torch.zeros(2, 3, 8), torch.zeros(8, 8), torch.zeros(8)
    mask = torch.ones(2, 3, dtype=torch.bool)
    if bad == "weight_shape":
        W = torch.zeros(8, 4)
    elif bad == "v_shape":
        v = torch.zeros(4)
    elif bad == "mask_dtype":
        mask = mask.float()
    elif bad == "mask_shape":
        mask = torch.ones(2, 4, dtype=torch.bool)
    elif bad == "rank":
        x = torch.zeros(6, 8)
    elif bad == "empty_bag":
        x, mask = torch.zeros(2, 0, 8), torch.ones(2, 0, dtype=torch.bool)
    with pytest.raises(ValueError):
        attention_pool(x, W, v, mask)
