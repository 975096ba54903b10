"""The port's int8 (W8A8) serving path against the JAX package, on the CPU.

Inputs, weights and BatchNorm statistics are made with numpy from a seed
and handed to both stacks; the JAX package's folded variables reach the port
through ``flax_mil_to_torch`` and its int8 tree through
``flax_qtree_to_torch``. On the CPU the K3 wrappers run their plain
versions (``kernels/qmm_requant.py``), whose float64 product is exact.

- (a) K3's plain version against the TPU kernel itself
  (``benchmarks/int8_pallas_probe.py::qmm_requant``) under the Pallas
  interpreter: identical int8.
- (b) its conv form against ``_qconv_q`` (jitted, as the serving path runs
  it) on every geometry of the family: identical int8; its residual form
  against ``_residual_relu_q(_qconv_q(..., relu=False), ...)`` with identity
  and projection skips at Bottleneck (1×1) and Basic (3×3) shapes, and the
  stem pass (``quantized_stages(..., stages=0)``) against JAX's
  ``_quantized_stages(..., stages=0)``: identical int8.
- (c) ``float_extract_amax``: features and site abs-maxes at ``rtol=1e-4``
  (float32 convolutions summed in another order).
- (d) ``quantize_resnet``: from the same folded weights and amaxes, equal
  int8 weights and scales.
- (e) ``quantized_extract`` from JAX's own qtree: per-sample cosine ≥ 0.9999
  (the stem's float32 sums and the residual's float arithmetic round in
  another order, which can move a requantized value by one step).
- (f) the CLIs with ``quantize: "int8"`` (each stack calibrating itself),
  and the int8 adapters sharing one qtree: see the tests' docstrings.
- (g) the int8 adapter is eval only.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli._common import quantize_mode
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.kernels.qmm_requant import (
    qconv_requant,
    qconv_residual_requant,
    qmm_requant,
    qmm_requant_plain,
    stem_requant_pool,
)
from multimodalbrainsurvival_torch.models import quantize as tq
from multimodalbrainsurvival_torch.models.convert import (
    flax_mil_to_torch,
    flax_qtree_to_torch,
)
from multimodalbrainsurvival_torch.models.folding import fold_resnet_state_dict
from multimodalbrainsurvival_torch.train.adapters import QuantizedMILAdapter
from multimodalbrainsurvival_tpu.models import quantize as jq
from multimodalbrainsurvival_tpu.models.folding import fold_resnet_variables
from multimodalbrainsurvival_tpu.models.resnet import (
    RESNET_CONSTRUCTORS as JAX_RESNETS,
)
from tests.test_torch_histo_cli import _random_state, _run_both, cohort  # noqa: F401
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["resnet18", "resnet50"]
IMG = 32


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, axis=-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _folded(arch: str):
    """JAX folded variables of a ResNet whose BN statistics and affine are
    numpy-randomized, and the same numbers as the port's folded
    ``state_dict``."""
    model = JAX_RESNETS[arch]()
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    rng = np.random.default_rng(7)

    def jitter(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "mean":
            return a + rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if leaf == "var":
            return a * np.exp(rng.normal(0.0, 0.2, a.shape)).astype(np.float32)
        return a

    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "batch_stats": jax.tree_util.tree_map_with_path(jitter, v["batch_stats"])}
    fv = jax.tree.map(np.asarray, fold_resnet_variables(v))
    return fv, flax_mil_to_torch(fv["params"])


def _input(seed: int, n: int = 3, img: int = IMG) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# --- (a) K3 plain vs the TPU kernel ------------------------------------------


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "int8_pallas_probe", os.path.join(REPO, "benchmarks", "int8_pallas_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_qmm_requant_plain_matches_tpu_kernel_interpreted(relu, monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    M, K, N = 512, 64, 256
    rng = np.random.default_rng(0)
    a, w = _int8(rng, (M, K)), _int8(rng, (K, N))
    s = (rng.uniform(0.5, 2, N) / 1e3).astype(np.float32)
    b = rng.uniform(-20, 20, N).astype(np.float32)
    want = np.asarray(_probe_module().qmm_requant(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(s), jnp.asarray(b), relu))
    got = qmm_requant(torch.from_numpy(a), torch.from_numpy(w.T.copy()),
                      torch.from_numpy(s), torch.from_numpy(b), relu=relu).numpy()
    assert got.dtype == np.int8 and 0 < (np.abs(got) == 127).mean() < 0.5
    np.testing.assert_array_equal(got, want)


def test_qmm_requant_plain_is_exact_at_the_deepest_k():
    """K = 4,608 (3×3×512): sums up to 127²·4,608 ≈ 7.4e7, past float32's
    exact 2**24; the plain version equals an int64 numpy oracle with the
    same float32 epilogue."""
    M, K, N = 8, 4608, 16
    rng = np.random.default_rng(1)
    a, w = _int8(rng, (M, K)), _int8(rng, (N, K))
    a[0], w[0] = 127, 127  # the largest sum
    s = np.full(N, 1e-6, np.float32)
    b = rng.uniform(-3, 3, N).astype(np.float32)
    acc = a.astype(np.int64) @ w.astype(np.int64).T
    assert acc[0, 0] == 127 * 127 * K
    y = acc.astype(np.float32) * s + b
    want = np.clip(np.rint(y), -127, 127).astype(np.int8)
    got = qmm_requant_plain(*map(torch.from_numpy, (a, w, s, b)), relu=False)
    np.testing.assert_array_equal(got.numpy(), want)


# --- (b) K3's conv form vs _qconv_q -----------------------------------------

# (kernel, stride, padding): every conv geometry of the ResNet family
GEOMETRIES = {"1x1_s1": (1, 1, 0), "1x1_s2": (1, 2, 0),
              "3x3_s1_p1": (3, 1, 1), "3x3_s2_p1": (3, 2, 1)}


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_qconv_plain_matches_jax_qconv_q(geom, relu):
    k, stride, pad = GEOMETRIES[geom]
    rng = np.random.default_rng(2)
    x = _int8(rng, (2, 9, 9, 32))  # odd size: a ragged stride-2 edge
    cp = {"k": _int8(rng, (k, k, 32, 24)),
          "ws": (rng.uniform(0.5, 2.0, 24) * 1e-3).astype(np.float32),
          "b": rng.uniform(-5, 5, 24).astype(np.float32)}
    s_in, s_out = np.float32(0.05), np.float32(0.1)
    fn = jax.jit(functools.partial(jq._qconv_q, stride=stride,
                                   padding=((pad, pad), (pad, pad)), relu=relu))
    want = np.asarray(fn(jnp.asarray(x), s_in, cp, s_out))
    got = tq.qconv_q(torch.from_numpy(x), torch.tensor(s_in),
                     flax_qtree_to_torch({"conv1": cp})["conv1"],
                     torch.tensor(s_out), stride=stride, padding=pad,
                     relu=relu).numpy()
    assert got.shape == want.shape and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


# (last conv's kernel and padding, skip) of a block: Bottleneck conv3 (1×1)
# and Basic conv2 (3×3), each with the identity skip (the block input at its
# own scale) and a projection skip (a stride-2 downsample of a larger input)
RESIDUAL_CASES = {"bottleneck_identity": (1, 0, False),
                  "bottleneck_projection": (1, 0, True),
                  "basic_identity": (3, 1, False),
                  "basic_projection": (3, 1, True)}


def _conv_params(rng, k, cin, cout):
    return {"k": _int8(rng, (k, k, cin, cout)),
            "ws": (rng.uniform(0.5, 2.0, cout) * 1e-3).astype(np.float32),
            "b": rng.uniform(-5, 5, cout).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(RESIDUAL_CASES))
def test_residual_form_plain_matches_jax(case):
    k, pad, projection = RESIDUAL_CASES[case]
    rng = np.random.default_rng(11)
    t_in = _int8(rng, (2, 7, 7, 32))  # the last conv's input
    cp = _conv_params(rng, k, 32, 24)
    s_a, s_t, s_out = np.float32(0.05), np.float32(0.08), np.float32(0.1)
    if projection:
        s_in, s_r = np.float32(0.04), np.float32(0.07)
        block_in = _int8(rng, (2, 13, 13, 16))
        dcp = _conv_params(rng, 1, 16, 24)
        r = np.asarray(jax.jit(functools.partial(jq._qconv_q, stride=2, relu=False))(
            jnp.asarray(block_in), s_in, dcp, s_r))
    else:
        s_r = np.float32(0.06)
        r = _int8(rng, (2, 7, 7, 24))

    # the conv jitted as in the test above; the residual op by op: under
    # jit XLA's CPU backend fuses t·s_t + r·s_r + requant and rounds
    # differently (a few outputs move by one step), while the port, on the
    # CPU and in the kernel, rounds each operation as written
    t = jax.jit(functools.partial(jq._qconv_q, padding=((pad, pad), (pad, pad)),
                                  relu=False))(jnp.asarray(t_in), s_a, cp, s_t)
    want = np.asarray(jq._residual_relu_q(t, s_t, jnp.asarray(r), s_r, s_out))
    got = tq.qconv_residual_q(
        torch.from_numpy(t_in), torch.tensor(s_a),
        flax_qtree_to_torch({"conv1": cp})["conv1"], torch.tensor(s_t),
        torch.from_numpy(r.copy()), torch.tensor(s_r), torch.tensor(s_out),
        padding=pad).numpy()
    assert got.shape == want.shape == (2, 7, 7, 24) and got.dtype == np.int8
    assert 0 < (got == 0).mean() < 0.9 and got.max() >= 32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("img", [IMG, IMG + 1], ids=["even", "odd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stem_pass_matches_jax_stages_0(arch, img):
    """``quantized_stages(..., stages=0)``: the stem conv, then the stem pass
    (on the CPU its plain version); an odd size has a ragged pool edge."""
    fv, _ = _folded(arch)
    amax = jq.merge_amax([jax.device_get(
        jq.float_extract_amax(fv, jnp.asarray(_input(5, n=4)), arch=arch)[1])])
    qtree = jq.quantize_resnet(fv, amax, arch=arch)
    x = _input(12, n=2, img=img)
    want, want_s = jax.jit(functools.partial(jq._quantized_stages, stages=0, arch=arch))(
        qtree, jnp.asarray(x))
    got, got_s = tq.quantized_stages(flax_qtree_to_torch(qtree), _nchw(x), stages=0,
                                     arch=arch)
    assert got.shape == want.shape == (2, img // 4 + img % 2, img // 4 + img % 2, 64)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_s.item() == float(want_s)


# --- (c)-(e) calibration, weight quantization, int8 forward ------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_float_extract_amax_matches_jax(arch):
    fv, state = _folded(arch)
    x = _input(3)
    want_f, want_amax = jq.float_extract_amax(fv, jnp.asarray(x), arch=arch)
    got_f, got_amax = tq.float_extract_amax(state, _nchw(x), arch=arch)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-4, atol=1e-5)
    assert set(got_amax) == set(want_amax)
    for site, v in want_amax.items():
        np.testing.assert_allclose(float(got_amax[site]), float(v), rtol=1e-4,
                                   err_msg=site)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_resnet_matches_jax(arch):
    fv, state = _folded(arch)
    amax = jq.merge_amax([jax.device_get(
        jq.float_extract_amax(fv, jnp.asarray(_input(4)), arch=arch)[1])])
    want = flax_qtree_to_torch(jq.quantize_resnet(fv, amax, arch=arch))
    got = tq.quantize_resnet(state, {k: float(v) for k, v in amax.items()}, arch=arch)
    assert set(got) == set(want)
    assert set(got["scales"]) == set(want["scales"])
    for site, s in want["scales"].items():
        assert got["scales"][site].dtype == torch.float32
        assert got["scales"][site].item() == s.item(), site
    for key in set(want) - {"scales"}:
        convs = {"": want[key]} if key == "conv1" else want[key]
        mine = {"": got[key]} if key == "conv1" else got[key]
        assert set(mine) == set(convs), key
        for name, cp in convs.items():
            for leaf in ("k", "ws", "b"):
                assert mine[name][leaf].dtype == cp[leaf].dtype
                torch.testing.assert_close(mine[name][leaf], cp[leaf], rtol=0,
                                           atol=0, msg=f"{key}.{name}.{leaf}")


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_extract_from_jax_qtree(arch):
    fv, _ = _folded(arch)
    x_cal, x_new = _input(5, n=4), _input(6, n=4)
    amax = jq.merge_amax([jax.device_get(
        jq.float_extract_amax(fv, jnp.asarray(x_cal), arch=arch)[1])])
    qtree = jq.quantize_resnet(fv, amax, arch=arch)
    fn = jax.jit(functools.partial(jq.quantized_extract, arch=arch))
    tqtree = flax_qtree_to_torch(qtree)
    for x in (x_cal, x_new):
        want = np.asarray(fn(qtree, jnp.asarray(x)))
        got = tq.quantized_extract(tqtree, _nchw(x), arch=arch).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _cosines(got, want).min() >= 0.9999


@pytest.mark.parametrize("arch", ARCHS)
def test_port_int8_encoder_tracks_its_float_encoder(arch):
    """The JAX package's contract for ``quantize: "int8"``
    (``tests/test_quantize.py``): per-sample cosine > 0.995 against the
    folded float features, on calibration and held-out inputs."""
    _, state = _folded(arch)
    x_cal, x_new = _nchw(_input(8, n=4)), _nchw(_input(9, n=4))
    _, amax = tq.float_extract_amax(state, x_cal, arch=arch)
    qtree = tq.quantize_resnet(state, tq.merge_amax([amax]), arch=arch)
    assert qtree["conv1"]["k"].dtype == torch.int8
    for x in (x_cal, x_new):
        ref, _ = tq.float_extract_amax(state, x, arch=arch)
        assert _cosines(tq.quantized_extract(qtree, x, arch=arch), ref).min() > 0.995


# --- (f) CLI frames ----------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def int8_outputs(request, cohort, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp(f"int8_{request.param}")
    return _run_both(cohort, tmp, "attention", False, quantize="int8",
                     model_name=request.param,
                     aggregator_hdim=512 if request.param == "resnet18" else 2048)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_int8_cli_frames_track_jax(int8_outputs, split):
    """Both CLIs with ``quantize: "int8"`` on one cohort and one set of
    weights. Each stack calibrates on its own float32 forward, so its site
    scales differ from the other's by 1-5 float32 ulps and a few
    requantized values move by one step; at 32 px the last feature map is
    1×1, so nothing averages such a step away. Measured on the CPU:
    per-case feature cosine ≥ 0.99963 (resnet18) and ≥ 0.99972 (resnet50);
    scores differ by up to 0.035 (resnet18) and 0.068 (resnet50), which is
    the size of int8 rounding itself here (the port's int8 scores against
    its float scores: up to 0.072 and 0.063). So the scores are held at
    ``atol=0.1`` here, and at ``atol=1e-2`` where both stacks share one
    qtree (``test_int8_adapter_from_jax_qtree_matches_jax``)."""
    jax_dir, torch_dir = int8_outputs
    want = pd.read_csv(jax_dir / f"init_flax_pathology_{split}_df.csv", index_col=0)
    got = pd.read_csv(torch_dir / f"init.pt_pathology_{split}_df.csv", index_col=0)
    assert list(got["id"]) == list(want["id"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=0, atol=0.1)
    want_f = np.loadtxt(jax_dir / f"pathology_features_{split}.csv", delimiter=",",
                        ndmin=2)
    got_f = np.loadtxt(torch_dir / f"pathology_features_{split}.csv", delimiter=",",
                       ndmin=2)
    assert got_f.shape == want_f.shape
    assert _cosines(got_f, want_f).min() >= 0.999


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_adapter_from_jax_qtree_matches_jax(arch):
    """The int8 adapters of both stacks, end to end from uint8 bags, with
    one qtree (calibrated by the JAX package) and one set of float weights:
    scores within ``atol=1e-2`` and bag embeddings at cosine ≥ 0.9999."""
    from multimodalbrainsurvival_tpu.cli.histo_train import (
        build_mil_model as jax_build_mil_model,
    )
    from multimodalbrainsurvival_tpu.config import Config as JaxConfig
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
    from multimodalbrainsurvival_tpu.train.adapters import (
        QuantizedMILAdapter as JaxQuantizedMILAdapter,
    )

    cfg = {"model_name": arch, "aggregator": "attention", "num_classes": 1,
           "aggregator_hdim": 512 if arch == "resnet18" else 2048}
    model = build_mil_model(Config(cfg))
    state = _random_state(model, seed=13)
    model = build_mil_model(Config(cfg), fold_bn=True).eval()
    model.load_state_dict(fold_resnet_state_dict(state))
    rng = np.random.default_rng(14)
    bag = rng.integers(0, 256, (2, 3, IMG, IMG, 3), np.uint8)
    mask = np.array([[True, True, True], [True, True, False]])

    folded = jax.tree.map(np.asarray, fold_resnet_variables(
        torch_mil_to_flax({k: v.numpy() for k, v in state.items()})))
    qtree = jq.quantize_mil_resnet(folded, [bag], arch=arch)
    jax_adapter = JaxQuantizedMILAdapter(
        model=jax_build_mil_model(JaxConfig(cfg), fold_bn=True), arch=arch)
    jarrays = {"patch_bag": jnp.asarray(bag), "bag_mask": jnp.asarray(mask),
               "sample_mask": jnp.ones((2,), bool)}
    variables = {"params": folded["params"], "qtree": qtree}
    want_out, _ = jax_adapter.apply(variables, jarrays, train=False)
    want_emb = jax_adapter.extract(variables, jarrays)

    adapter = QuantizedMILAdapter(model=model, device=torch.device("cpu"),
                                  qtree=flax_qtree_to_torch(qtree), arch=arch)
    arrays = {"patch_bag": torch.from_numpy(bag), "bag_mask": torch.from_numpy(mask)}
    np.testing.assert_allclose(adapter.apply(arrays).numpy(), np.asarray(want_out),
                               rtol=0, atol=1e-2)
    assert _cosines(adapter.extract(arrays).numpy(), np.asarray(want_emb)).min() >= 0.9999


# --- (g) eval only -----------------------------------------------------------


def test_quantized_adapter_is_eval_only(tmp_path):
    cfg = Config({"model_name": "resnet18", "aggregator": "attention",
                  "aggregator_hdim": 512, "fold_bn": True})
    model = build_mil_model(cfg, fold_bn=True).eval()
    model.load_state_dict(_random_state(model, seed=3))
    bag = np.random.default_rng(4).integers(0, 256, (2, 3, IMG, IMG, 3), np.uint8)
    qtree = tq.quantize_mil_resnet(model.resnet, [bag], arch="resnet18")
    adapter = QuantizedMILAdapter(model=model, device=torch.device("cpu"),
                                  qtree=qtree, arch="resnet18")
    arrays = {"patch_bag": torch.from_numpy(bag),
              "bag_mask": torch.ones(2, 3, dtype=torch.bool)}
    assert adapter.apply(arrays).shape == (2, 1)
    assert adapter.extract(arrays).shape == (2, 512)
    with pytest.raises(ValueError, match="eval-only"):
        adapter.apply(arrays, train=True)


def test_quantize_mode():
    assert quantize_mode(Config({})) == ""
    assert quantize_mode(Config({"quantize": "INT8"})) == "int8"
    with pytest.raises(ValueError, match="quantize mode"):
        quantize_mode(Config({"quantize": "int4"}))


def test_conv_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    w = torch.zeros(3, 1, 1, 8, dtype=torch.int8)
    s = torch.ones(3)
    with pytest.raises(ValueError, match="int8"):
        qconv_requant(x.float(), w, s, s)
    with pytest.raises(ValueError, match="channels"):
        qconv_requant(x, w[..., :4].contiguous(), s, s)
    with pytest.raises(ValueError, match="float32"):
        qconv_requant(x, w, s.double(), s)
    one = torch.tensor(1.0)
    r = torch.zeros(1, 4, 4, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="s_t must be one float32"):
        qconv_residual_requant(x, w, s, s, r, s, one, one)
    with pytest.raises(ValueError, match="s_out must be one float32"):
        qconv_residual_requant(x, w, s, s, r, one, one, one.double())
    with pytest.raises(ValueError, match="bias"):
        stem_requant_pool(torch.zeros(1, 3, 4, 4), torch.zeros(4), one)
    with pytest.raises(ValueError, match="float32"):
        stem_requant_pool(torch.zeros(1, 3, 4, 4).double(), torch.zeros(3), one)
