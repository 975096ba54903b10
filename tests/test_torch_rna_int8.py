"""The port's int8 RNA MLP (``models/quantize.py``: ``quantize_mlp``,
``quantized_mlp``) and int8 RNA serving (``quantize: "int8"`` in
``rna_savescore`` and ``rna_extractfeatures``) against the JAX package, on
the CPU.

With one qtree (the JAX package's, carried across by
``flax_mlp_qtree_to_torch``) the two stacks compute the same int8 values,
the same int32 products and the same epilogue in the same order, so the
outputs agree to float32 rounding (``rtol=1e-6``). Each stack quantizing
its own weights gives the same int8 weights and scales. The CLIs are held
at the RNA CLIs' tolerances (``rtol=1e-4, atol=1e-5``): XLA may fuse the
epilogue's multiply and add, and a product rounded once instead of twice
moves a requantized value across a rounding edge now and then.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import rna_extractfeatures, rna_savescore
from multimodalbrainsurvival_torch.models.convert import flax_mlp_qtree_to_torch
from multimodalbrainsurvival_torch.models.quantize import (
    _requant_rows,
    int8_matmul,
    quantize_mlp,
    quantize_rna_encoder,
    quantized_mlp,
)
from multimodalbrainsurvival_torch.models.rna import RNAEncoder
from multimodalbrainsurvival_tpu.models import quantize as jq
from tests.test_torch_rna_cli import (  # noqa: F401  (the fixture)
    SPLITS,
    _config,
    _random_state,
    _run,
    _write,
    cohort,
)
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

GENES = 16


def _encoder_and_flax(seed: int, genes: int = GENES, hidden=(4096, 2048)):
    """A seeded port ``RNAEncoder`` and its layers as flax Dense params."""
    torch.manual_seed(seed)
    enc = RNAEncoder(genes, hidden)
    params = [{"kernel": m.weight.detach().numpy().T.copy(),
               "bias": m.bias.detach().numpy().copy()}
              for m in enc if isinstance(m, torch.nn.Linear)]
    return enc, params


def _rows(n, genes=GENES, seed=0):
    return np.random.default_rng(seed).standard_normal((n, genes)).astype(np.float32)


def test_port_quantizes_the_weights_as_the_jax_package():
    enc, params = _encoder_and_flax(1)
    want = flax_mlp_qtree_to_torch(jax.tree.map(np.asarray, jq.quantize_mlp(params)))
    got = quantize_rna_encoder(enc)
    for g, w in zip(got["layers"], want["layers"]):
        assert g["k"].dtype == torch.int8 and g["k"].shape == w["k"].shape
        for key in ("k", "ws", "b"):
            assert torch.equal(g[key], w[key]), key


def test_rows_quantize_as_the_jax_package():
    y = _rows(9, 40, seed=2) * np.float32(3.0)
    y[4] = 0.0  # an all-zero row takes the scale floor
    want_q, want_s = jq._requant_rows(jnp.asarray(y))
    got_q, got_s = _requant_rows(torch.from_numpy(y))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("rows", [3, 16, 17, 40])
def test_quantized_mlp_matches_jax_with_one_qtree(rows):
    _, params = _encoder_and_flax(3)
    jtree = jq.quantize_mlp(params)
    x = _rows(rows, seed=rows)
    want = np.asarray(jq.quantized_mlp(jtree, jnp.asarray(x)))
    got = quantized_mlp(flax_mlp_qtree_to_torch(jax.tree.map(np.asarray, jtree)),
                        torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (rows, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 13, 5), (16, 16, 8), (17, 12778, 24), (40, 9, 11)])
def test_padding_changes_no_product(shape):
    """K padded to a multiple of 8 (at quantize time and per call), N to a
    multiple of 8, and a batch of 16 rows or fewer padded past 16: the
    int32 products equal the unpadded ones."""
    M, K, N = shape
    g = torch.Generator().manual_seed(M)
    x_q = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    layer = quantize_mlp([torch.nn.Linear(K, N)])["layers"][0]
    assert layer["k"].shape == (N + -N % 8, K + -K % 8)
    want = x_q.to(torch.int64) @ layer["k"][:N, :K].to(torch.int64).t()
    got = int8_matmul(x_q, layer["k"], N)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.to(torch.int64), want)


def test_int8_embeddings_keep_cosine_to_the_float_encoder():
    """The JAX contract for ``quantize: "int8"``: per-sample cosine > 0.995
    to the float path, at the reference width."""
    enc, _ = _encoder_and_flax(4, genes=12778)
    x = torch.from_numpy(_rows(24, 12778, seed=5))
    with torch.no_grad():
        want = enc.eval()(x)
    got = quantized_mlp(quantize_rna_encoder(enc), x)
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=1)
    assert cos.min().item() > 0.995, cos


@pytest.fixture(scope="module")
def int8_runs(cohort, tmp_path_factory):  # noqa: F811
    """``rna_savescore`` and ``rna_extractfeatures`` with ``quantize:
    "int8"`` through both stacks' CLI mains, from one seeded ``.pt``."""
    from multimodalbrainsurvival_tpu.cli import (
        rna_extractfeatures as jax_extract,
        rna_savescore as jax_savescore,
    )
    from multimodalbrainsurvival_tpu.cli.convert_checkpoint import convert

    tmp = tmp_path_factory.mktemp("rna_int8")
    pt = tmp / "model.pt"
    torch.save(_random_state(seed=31), str(pt))
    flax_model = str(tmp / "model_flax")
    with contextlib.redirect_stdout(io.StringIO()):
        convert(str(pt), "rna", flax_model)
    out = {}
    for name, save, extract, model, extra in (
        ("jax", jax_savescore, jax_extract, flax_model, []),
        ("torch", rna_savescore, rna_extractfeatures, str(pt), ["--device", "cpu"]),
    ):
        cfg = _config(cohort, tmp / name, model_path=model, quantize="int8",
                      output_path=str(tmp / name / "serve"))
        path = _write(tmp / f"{name}.json", cfg)
        logs = _run(save.main, ["--config", path] + extra)
        logs += _run(extract.main, ["--config", path] + extra)
        out[name] = (tmp / name / "serve", logs)
    return out


@pytest.mark.parametrize("split", SPLITS)
def test_int8_savescore_frames_match_jax(int8_runs, split):
    (jax_out, _), (torch_out, log) = int8_runs["jax"], int8_runs["torch"]
    assert "quantized RNA encoder to int8" in log
    want = pd.read_csv(jax_out / f"rna_{split}_df.csv", index_col=0)
    got = pd.read_csv(torch_out / f"rna_{split}_df.csv", index_col=0)
    assert list(got.columns) == ["id", "score", "survival_months", "vital_status"]
    assert list(got["id"]) == list(want["id"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("split", SPLITS)
def test_int8_extractfeatures_match_jax(int8_runs, split):
    (jax_out, _), (torch_out, _) = int8_runs["jax"], int8_runs["torch"]
    cases = f"rna_cases_{split}.csv"
    assert (torch_out / cases).read_bytes() == (jax_out / cases).read_bytes()
    want = np.loadtxt(jax_out / f"rna_features_{split}.csv", delimiter=",")
    got = np.loadtxt(torch_out / f"rna_features_{split}.csv", delimiter=",")
    assert got.shape == want.shape and got.shape[1] == 2048
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
