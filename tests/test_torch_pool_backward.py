"""K1's gradient: ``AttentionPool`` (the pool's ``autograd.Function``) and
its analytic backward ``attention_pool_backward`` on the CPU.

- Against finite differences in float32 (``torch.autograd.gradcheck`` at
  ``eps=1e-3``, ``atol=1e-3``, ``rtol=1e-2``: a step that float32's
  rounding leaves 1e-4 of room; a wrong term is off by O(1)), and against
  autograd of the plain version, float32 at ``rtol=1e-5`` and 1e-6 of the
  gradient's scale, with a cotangent on either output alone too.
- Against ``jax.grad`` of the JAX package's composition at HEAD,
  ``TanhAttention`` + ``masked_bag_mean`` (``models/aggregators.py:52-73``,
  ``models/mil.py:22-28``), with padded bags, a padded sample, bag 1, and a
  cotangent on the attention as well as on the pooled output: float32 at
  ``rtol=1e-4`` and an absolute floor of 2e-5 of the gradient's scale
  (max |g|): float32 sums in another order, which cancel, put a near-zero
  element of ``dweight`` up to 7.2e-6 of the scale off (measured).
- Through the port's ``TanhAttention`` in a bfloat16 model: the casts to
  bfloat16 stay differentiable, so float32 features, ``linear.weight`` and
  ``vector`` all get gradients.

On the card the same Function runs K1 forward; ``tests/test_torch_kernels.py``
and ``chip_smoke.py`` hold it there against autograd of the plain version.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.kernels import attention_pool as k1
from multimodalbrainsurvival_torch.kernels.attention_pool import (
    AttentionPool,
    attention_pool_backward,
    attention_pool_plain,
    pool,
)
from multimodalbrainsurvival_torch.models.aggregators import TanhAttention
from multimodalbrainsurvival_tpu.models.aggregators import (
    TanhAttention as JaxTanhAttention,
)
from multimodalbrainsurvival_tpu.models.mil import masked_bag_mean

# (B, bag, D, real patches per bag)
CASES = {
    "padded_bags": (4, 6, 32, [6, 3, 1, 5]),
    "padded_sample": (3, 5, 16, [5, 0, 2]),
    "bag_1": (3, 1, 16, [1, 1, 0]),
    "d72": (2, 7, 72, [7, 4]),
}


def _inputs(case, seed=0, dtype=np.float32):
    B, bag, D, lengths = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, bag, D)).astype(dtype)
    weight = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(dtype)  # nn.Linear layout
    v = rng.normal(size=(D,)).astype(dtype)
    mask = np.arange(bag)[None, :] < np.asarray(lengths)[:, None]
    g_out = rng.normal(size=(B, D)).astype(dtype)
    g_attn = rng.normal(size=(B, bag)).astype(dtype)
    return x, weight, v, mask, g_out, g_attn


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_passes_gradcheck_in_float32(case):
    x, weight, v, mask, _, _ = _torch(*_inputs(case))
    args = (x.requires_grad_(), weight.requires_grad_(), v.requires_grad_(), mask)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Input #", UserWarning)  # not float64
        assert torch.autograd.gradcheck(AttentionPool.apply, args, eps=1e-3,
                                        atol=1e-3, rtol=1e-2)


def _function_and_plain_grads(case, seed, cotangents):
    """dx, dweight, dv of ``pool`` and of autograd through the plain
    version, for the loss ``Σ <g, output>`` over ``cotangents`` ("out",
    "attn" or both): autograd hands the Function a zero cotangent for an
    output the loss does not use."""
    x, weight, v, mask, g_out, g_attn = _torch(*_inputs(case, seed=seed))
    grads = {}
    for name, fn in (("function", pool), ("plain", attention_pool_plain)):
        leaves = [t.clone().requires_grad_() for t in (x, weight, v)]
        out, attn = fn(*leaves, mask)
        outputs = {"out": (out, g_out), "attn": (attn, g_attn)}
        torch.autograd.backward(*zip(*(outputs[k] for k in cotangents)))
        grads[name] = [t.grad for t in leaves]
    return grads["function"], grads["plain"]


@pytest.mark.parametrize("cotangents", [("out", "attn"), ("out",), ("attn",)],
                         ids=["both", "out_only", "attn_only"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_equals_autograd_of_plain(case, cotangents):
    got, want = _function_and_plain_grads(case, 1, cotangents)
    for name, g, w in zip(("dx", "dweight", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * max(w.abs().max(), 1e-30),
                                   msg=name)


def _jax_grads(x, weight, v, mask, g_out, g_attn):
    """jax.grad of <g_out, pooled> + <g_attn, attention> through the JAX
    composition; the Dense kernel is the port's weight transposed."""
    agg = JaxTanhAttention(dim=x.shape[-1])

    def f(x, kernel, vector):
        variables = {"params": {"vector": vector, "linear": {"kernel": kernel}}}
        out, attn = agg.apply(variables, x, mask=jnp.asarray(mask))
        pooled = masked_bag_mean(out, jnp.asarray(mask))
        return jnp.sum(pooled * g_out) + jnp.sum(attn * g_attn)

    dx, dkernel, dv = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(weight.T), jnp.asarray(v))
    return np.asarray(dx), np.asarray(dkernel).T, np.asarray(dv)


@pytest.mark.parametrize("with_attn_cotangent", [True, False],
                         ids=["attn_cotangent", "out_only"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_grad_of_the_jax_composition(case, with_attn_cotangent):
    x, weight, v, mask, g_out, g_attn = _inputs(case, seed=2)
    if not with_attn_cotangent:
        g_attn = np.zeros_like(g_attn)
    want = _jax_grads(x, weight, v, mask, g_out, g_attn)
    tx, tw, tv = (t.requires_grad_() for t in _torch(x, weight, v))
    out, attn = pool(tx, tw, tv, torch.from_numpy(mask))
    torch.autograd.backward((out, attn), _torch(g_out, g_attn))
    for name, got, w in zip(("dx", "dweight", "dv"), (tx.grad, tw.grad, tv.grad), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=name)
    # pads get no gradient
    assert not tx.grad[~torch.from_numpy(mask)].any()


def test_bag_of_one_patch_trains_no_attention():
    """A bag of one real patch has softmax weight 1 whatever its logit: the
    pool's dweight and dv are exactly 0 and dx is the output's cotangent."""
    x, weight, v, mask, g_out, _ = _torch(*_inputs("bag_1", seed=3))
    leaves = [t.clone().requires_grad_() for t in (x, weight, v)]
    out, _ = pool(*leaves, mask)
    out.backward(g_out)
    dx, dweight, dv = (t.grad for t in leaves)
    assert not dweight.any() and not dv.any()
    torch.testing.assert_close(dx[:, 0], g_out * mask, rtol=0, atol=0)


def test_bf16_aggregator_sends_gradients_to_its_float32_leaves():
    """A bfloat16 ``TanhAttention`` reads bf16 casts of its float32 inputs
    and parameters; the gradient goes back through the casts, one backward
    call per forward, ``dx`` in bf16 before the cast back."""
    x, weight, v, mask, g_out, _ = _torch(*_inputs("padded_bags", seed=4))
    agg = TanhAttention(dim=x.shape[-1], dtype=torch.bfloat16)
    with torch.no_grad():
        agg.linear.weight.copy_(weight)
        agg.vector.copy_(v)
    feats = x.clone().requires_grad_()
    calls = k1.attention_pool_backward.calls
    out, attn = agg(feats, mask)
    assert out.dtype == attn.dtype == torch.float32
    (out * g_out).sum().backward()
    assert k1.attention_pool_backward.calls == calls + 1
    for t in (feats, agg.linear.weight, agg.vector):
        assert t.grad is not None and t.grad.dtype == torch.float32
        assert torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0
    # against the float32 backward on the same bf16-rounded inputs
    xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    _, want_attn = attention_pool_plain(xb, wb, v, mask)
    want = attention_pool_backward(xb, wb, v, mask, want_attn, g_out,
                                   torch.zeros_like(want_attn))
    torch.testing.assert_close(feats.grad, want[0].float(), rtol=0, atol=0)
    torch.testing.assert_close(agg.linear.weight.grad, want[1].float(), rtol=0, atol=0)
    torch.testing.assert_close(agg.vector.grad, want[2], rtol=0, atol=0)


def test_eval_forward_saves_no_graph():
    """Under ``inference_mode`` (serving) the Function runs forward only."""
    x, weight, v, mask, _, _ = _torch(*_inputs("bag_1"))
    with torch.inference_mode():
        out, attn = pool(x, weight, v, mask)
    want = attention_pool_plain(x, weight, v, mask)
    torch.testing.assert_close(out, want[0], rtol=0, atol=0)
    torch.testing.assert_close(attn, want[1], rtol=0, atol=0)
    assert out.grad_fn is None
