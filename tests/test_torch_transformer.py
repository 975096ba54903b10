"""The port's ``TransformerAggregator`` and ``ResNetProject`` against the
JAX modules, on the CPU, through ``flax_mil_to_torch``.

- float32 eval with padded patches and a fully padded bag (``rtol=1e-5``);
  the converted tree loads strictly (no ``num_batches_tracked`` for the
  LayerNorms) and ``torch_transformer_to_flax`` below inverts it;
- bfloat16 eval, within 2^-6 of the output's scale: both stacks round every
  product and residual to bfloat16, in other orders (flax's softmax runs in
  bfloat16, the port's in float32);
- gradients against ``jax.grad`` with dropout off (``rtol=1e-4``);
- train-mode dropout as flax's: one ``(bag, bag)`` keep mask on the
  attention weights, shared by every bag and head
  (``broadcast_dropout=True``), and a full mask after the MLP's GELU, kept
  values scaled by ``1 / (1 - rate)``, all drawn from the generator given;
- ``ResNetProject`` (tanh of a 200-wide projection of the embedding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.models import ResNetProject
from multimodalbrainsurvival_torch.models.aggregators import (
    FlaxAttention,
    TransformerAggregator,
    make_aggregator,
)
from multimodalbrainsurvival_torch.models.convert import flax_mil_to_torch
from multimodalbrainsurvival_torch.models.resnet import resnet18
from multimodalbrainsurvival_tpu.models import resnet as jax_resnet
from multimodalbrainsurvival_tpu.models.aggregators import (
    TransformerAggregator as JaxTransformer,
)
from multimodalbrainsurvival_tpu.models.mil import masked_bag_mean as jax_bag_mean

B, BAG, D, HEADS, MLP, LAYERS = 3, 5, 32, 4, 48, 2


def torch_transformer_to_flax(state: dict, num_heads: int) -> dict:
    """The port's transformer ``state_dict`` (keys without the
    ``aggregator.`` prefix) → the flax ``TransformerAggregator`` params:
    the inverse of ``flax_mil_to_torch`` on that tree."""
    out: dict = {}
    n_layers = len({k.split(".")[1] for k in state})
    for i in range(n_layers):
        p = f"layers.{i}."

        def a(key):
            return np.asarray(state[p + key], np.float32)

        dim = a("ln1.weight").shape[0]
        hd = dim // num_heads
        for ln in ("ln1", "ln2"):
            out[f"{ln}_{i}"] = {"scale": a(f"{ln}.weight"), "bias": a(f"{ln}.bias")}
        attn = {name: {"kernel": a(f"attn.{t}.weight").T.reshape(dim, num_heads, hd),
                       "bias": a(f"attn.{t}.bias").reshape(num_heads, hd)}
                for name, t in (("query", "q"), ("key", "k"), ("value", "v"))}
        attn["out"] = {"kernel": a("attn.o.weight").T.reshape(num_heads, hd, dim),
                       "bias": a("attn.o.bias")}
        out[f"attn_{i}"] = attn
        for mlp in ("mlp1", "mlp2"):
            out[f"{mlp}_{i}"] = {"kernel": a(f"{mlp}.weight").T, "bias": a(f"{mlp}.bias")}
    return out


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.0, (B, BAG, D)).astype(np.float32)
    mask = np.ones((B, BAG), bool)
    mask[1, 3:] = False  # padded patches
    mask[2, :] = False   # a fully padded bag (a padded final batch's row)
    return x, mask


def _flax_params(dtype=jnp.float32, dropout=0.2, seed=0):
    """A flax transformer and its params, biases and scales moved off their
    init so that every leaf is checked."""
    x, mask = _inputs()
    model = JaxTransformer(num_layers=LAYERS, dim=D, num_heads=HEADS, mlp_dim=MLP,
                           dropout=dropout, dtype=dtype)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mask))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0.0, 0.1, v.shape).astype(np.float32), params)
    return model, params


def _port(params, dtype=torch.float32, dropout=0.2):
    model = TransformerAggregator(num_layers=LAYERS, dim=D, num_heads=HEADS,
                                  mlp_dim=MLP, dropout=dropout, dtype=dtype)
    state = flax_mil_to_torch({"aggregator": params["params"]})
    model.load_state_dict({k.removeprefix("aggregator."): v for k, v in state.items()},
                          strict=True)
    return model


def _jax_pooled(model, params, x, mask, **kw):
    y, w = model.apply(params, jnp.asarray(x), jnp.asarray(mask), **kw)
    return np.asarray(jax_bag_mean(y, jnp.asarray(mask)), np.float32), np.asarray(w)


def test_converted_tree_loads_strictly_and_inverts():
    _, params = _flax_params()
    state = flax_mil_to_torch({"aggregator": params["params"]})
    assert not any(k.endswith("num_batches_tracked") for k in state)
    assert "aggregator.layers.1.attn.o.weight" in state
    assert state["aggregator.layers.0.attn.q.weight"].shape == (D, D)
    back = torch_transformer_to_flax(
        {k.removeprefix("aggregator."): v.numpy() for k, v in state.items()}, HEADS)
    for (path, want), (_, got) in zip(
            jax.tree_util.tree_flatten_with_path(params["params"])[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    model = make_aggregator("transformer", D, hdim=MLP, transformer_layers=LAYERS)
    assert model.layers[0].mlp1.weight.shape == (MLP, D)
    assert isinstance(model.layers[0].attn, FlaxAttention)


def test_float32_eval_matches_flax_with_pads_and_an_empty_bag():
    model, params = _flax_params()
    x, mask = _inputs()
    want, want_w = _jax_pooled(model, params, x, mask)
    port = _port(params).eval()
    with torch.no_grad():
        got, w = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(w.numpy(), want_w)
    assert not got[2].any()  # the empty bag pools to 0, not NaN


def test_bfloat16_eval_tracks_flax():
    model, params = _flax_params(dtype=jnp.bfloat16)
    x, mask = _inputs(seed=3)
    want, _ = _jax_pooled(model, params, x, mask)
    port = _port(params, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2**-6 * scale


def test_gradients_match_jax_grad_without_dropout():
    model, params = _flax_params(dropout=0.0)
    x, mask = _inputs(seed=5)
    cot = np.random.default_rng(7).normal(size=(B, D)).astype(np.float32)

    def loss(p, xx):
        y, _ = model.apply(p, xx, jnp.asarray(mask), train=True)
        return jnp.sum(jax_bag_mean(y, jnp.asarray(mask)) * cot)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    port = _port(params, dropout=0.0).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    pooled, _ = port(xt, torch.from_numpy(mask))
    (pooled * torch.from_numpy(cot)).sum().backward()
    want = flax_mil_to_torch({"aggregator": jax.tree.map(np.asarray, g_params["params"])})
    for name, p in port.named_parameters():
        w = want[f"aggregator.{name}"].numpy()
        if name.endswith("attn.k.bias"):
            # a key bias adds q·b to every logit of a query: the softmax
            # ignores it, and both gradients are float32 noise around 0
            scale = np.abs(want[f"aggregator.{name[:-4]}weight"].numpy()).max()
            assert max(np.abs(w).max(), p.grad.abs().max().item()) <= 1e-5 * scale
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=name)
    gx = np.asarray(g_x)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=1e-4, atol=1e-4 * np.abs(gx).max())
    assert not xt.grad[2].any()  # nothing flows back from an empty bag


def _attention_by_hand(attn: FlaxAttention, z, mask, keep, keep_prob):
    """flax's self-attention with a given broadcast keep mask, written out."""
    Bz, bag, dim = z.shape
    H = attn.num_heads
    hd = dim // H

    def heads(layer):
        return (z @ layer.weight.T + layer.bias).view(Bz, bag, H, hd).transpose(1, 2)

    logits = heads(attn.q) / np.sqrt(hd) @ heads(attn.k).transpose(-1, -2)
    logits = torch.where(mask[:, None, None, :], logits, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, -1) * (keep.float() / keep_prob)[None, None]
    out = (w @ heads(attn.v)).transpose(1, 2).reshape(Bz, bag, dim)
    return out @ attn.o.weight.T + attn.o.bias


def test_attention_dropout_is_one_mask_shared_by_bags_and_heads():
    _, params = _flax_params()
    attn = _port(params).layers[0].attn.train()
    x, mask = _inputs(seed=9)
    mask[2, :2] = True
    z, m = torch.from_numpy(x), torch.from_numpy(mask)
    g = torch.Generator().manual_seed(4)
    keep = torch.rand((BAG, BAG), generator=torch.Generator().manual_seed(4)) < 0.8
    assert 0 < keep.sum() < BAG * BAG
    with torch.no_grad():
        got = attn(z, m, g)
        want = _attention_by_hand(attn, z, m, keep, 0.8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the generator moved by exactly one (bag, bag) draw
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=_advanced(4, (BAG, BAG))))


def _advanced(seed, shape):
    g = torch.Generator().manual_seed(seed)
    torch.rand(shape, generator=g)
    return g


def test_mlp_dropout_is_a_full_mask_at_the_rate():
    from multimodalbrainsurvival_torch.models.aggregators import _dropout

    x = torch.ones(64, 64, 48)
    y = _dropout(x, 0.2, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    # not broadcast: the rows' masks differ
    assert not torch.equal(kept[0], kept[1])


def test_train_mode_draws_from_the_generator_and_eval_does_not():
    _, params = _flax_params()
    port = _port(params)
    x, mask = (torch.from_numpy(a) for a in _inputs(seed=2))
    runs = []
    for seed in (1, 1, 2):
        port.train()
        runs.append(port(x, mask, torch.Generator().manual_seed(seed))[0].detach())
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    port.eval()
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    port(x, mask, g)
    assert torch.equal(g.get_state(), state)


@pytest.mark.parametrize("hdim", [200, 24])
def test_resnet_project_matches_jax(hdim):
    jmodel = jax_resnet.ResNetProject(resnet=jax_resnet.resnet18(), hdim=hdim)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = jax.tree.map(np.asarray,
                             jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # BatchNorm statistics off their init, and a projection whose tanh is
    # not saturated
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree.map(
        lambda v: np.abs(v + rng.normal(0.0, 0.1, v.shape)).astype(np.float32),
        variables["batch_stats"])
    project = variables["params"]["project"]
    project["kernel"] = project["kernel"] * 0.05
    project["bias"] = rng.normal(0.0, 0.1, project["bias"].shape).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    port = ResNetProject(resnet18(num_classes=None), hdim=hdim).eval()
    port.load_state_dict(flax_mil_to_torch(variables["params"], variables["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (2, hdim) and np.abs(want).max() < 0.99
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
