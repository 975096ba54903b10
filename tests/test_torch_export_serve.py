"""The port's exported serving (``artifact.py``, ``kernels/ops.py``,
``cli/export_model.py``, ``cli/serve.py``) and ``convert_checkpoint``
against the JAX package's, on the CPU.

One cohort (ResNet-18 at 32 px, 12 ``rna_`` and 16 ``feature_`` columns,
numpy-seeded), one set of weights per model as a port ``.pt`` (the JAX
CLIs read the same numbers through ``torch_*_to_flax``). Each artifact
kind is exported by both CLIs and called on the same inputs at two batch
and bag sizes, which also shows that one program serves every size.
Tolerances: float32 outputs at ``rtol=1e-4, atol=1e-5`` (the histo serving
tolerance); int8 with the JAX package's qtree given to the port: scores at
``atol=1e-2``, embeddings at cosine ≥ 0.9999
(``tests/test_torch_quantize.py``'s shared-qtree bounds).
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch import artifact
from multimodalbrainsurvival_torch.cli import _common, convert_checkpoint, export_model, serve
from multimodalbrainsurvival_torch.cli.feature_train import build_feature_model
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.cli.joint_train import build_joint_model
from multimodalbrainsurvival_torch.cli.rna_train import build_rna_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.kernels import fused_stage, ops
from multimodalbrainsurvival_torch.models.convert import flax_qtree_to_torch
from tests.helpers import make_patch_dir, make_survival_csv
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

IMG, GENES, FEATS = 32, 12, 16
WSIS = [f"E{i}" for i in range(4)]
TOL = dict(rtol=1e-4, atol=1e-5)


def _random_state(model, seed):
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            state[k] = v
        elif k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
            state[k] = torch.tensor(rng.uniform(0.5, 1.5, v.shape), dtype=torch.float32)
        elif v.dim() == 1:
            state[k] = torch.tensor(rng.normal(0.0, 0.1, v.shape), dtype=torch.float32)
        else:
            state[k] = torch.tensor(rng.normal(0.0, 1.0, v.shape) / np.sqrt(v[0].numel()),
                                    dtype=torch.float32)
    return state


def _base(tmp):
    return {"model_name": "resnet18", "aggregator": "attention", "aggregator_hdim": 512,
            "num_classes": 1, "img_size": IMG, "batch_size": 2, "compute_dtype": "float32",
            "data_path": str(tmp / "patches"), "train_csv_path": str(tmp / "cohort.csv"),
            "val_csv_path": str(tmp / "cohort.csv"), "test_csv_path": str(tmp / "cohort.csv"),
            "train_bag_size": 2, "val_bag_size": 2, "max_patch_per_wsi_train": 4,
            "max_patch_per_wsi_val": 4, "num_workers": 1, "dropout": 0.0}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from multimodalbrainsurvival_tpu.models import convert as jconvert
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    tmp = tmp_path_factory.mktemp("export")
    for i, w in enumerate(WSIS):
        make_patch_dir(str(tmp / "patches"), w, 4, img_size=IMG, seed=40 + i)
    make_survival_csv(str(tmp / "cohort.csv"), ["c0", "c1", "c2", "c3"],
                      wsi_names=[f"{w}.svs" for w in WSIS], n_rna=GENES, n_feature=FEATS,
                      seed=1)
    config = Config(_base(tmp))
    models = {"mil": (build_mil_model(config), jconvert.torch_mil_to_flax),
              "joint": (build_joint_model(config, in_features=GENES),
                        jconvert.torch_joint_to_flax),
              "rna": (build_rna_model(config, in_features=GENES), jconvert.torch_rna_to_flax),
              "feature": (build_feature_model(config, in_features=FEATS),
                          jconvert.torch_feature_to_flax)}
    states = {}
    for i, (name, (model, to_flax)) in enumerate(models.items()):
        state = _random_state(model, seed=20 + i)
        torch.save(state, str(tmp / f"{name}.pt"))
        Checkpointer().save(str(tmp / f"{name}_flax"), jax.tree.map(
            np.asarray, to_flax({k: v.numpy() for k, v in state.items()})), block=True)
        states[name] = state
    return tmp, states


def _export_both(tmp, name, model, **keys):
    """Both export_model CLIs on one config; returns (JAX, port) artifacts."""
    from multimodalbrainsurvival_tpu.cli import export_model as jax_export_model
    from multimodalbrainsurvival_tpu.serving import load_artifact as jax_load

    out = {}
    for stack, main, model_path, extra in (
            ("jax", jax_export_model.main, f"{model}_flax", []),
            ("port", export_model.main, f"{model}.pt", ["--device", "cpu"])):
        cfg = dict(_base(tmp), model_path=str(tmp / model_path),
                   export_path=str(tmp / f"art_{name}_{stack}"), **keys)
        path = tmp / f"export_{name}_{stack}.json"
        path.write_text(json.dumps(cfg))
        main(["--config", str(path)] + extra)
        out[stack] = cfg["export_path"]
    return jax_load(out["jax"]), artifact.load_artifact(out["port"])


def _inputs(meta, b, g, seed):
    rng = np.random.default_rng(seed)
    arrays = []
    for name, dtype, dims in serve.parse_convention(meta):
        shape = [b] + [g if d is None else d for d in dims[1:]]
        if name == "patch_bag":
            arrays.append(rng.integers(0, 256, shape, dtype=np.uint8))
        elif name == "bag_mask":
            m = np.ones(shape, np.float32)
            m[0, -1] = 0.0 if g > 1 else 1.0
            arrays.append(m)
        else:
            arrays.append(rng.normal(size=shape).astype(np.float32))
    return arrays


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _compare(theirs, ours, int8=False):
    assert ours.meta["calling_convention"] == theirs.meta["calling_convention"]
    for key in ("kind", "quantize", "arch", "img_size", "in_channels", "in_features",
                "rna_features", "fold_bn", "aggregator"):
        assert ours.meta.get(key) == theirs.meta.get(key), key
    assert ours.meta["platforms"] == ["cpu"] and "torch_version" in ours.meta
    for i, (b, g) in enumerate(((1, 2), (3, 5))):
        arrays = _inputs(ours.meta, b, g, seed=i)
        want = theirs.call(*[jnp.asarray(a) for a in arrays])
        got = ours.call(*[torch.from_numpy(a) for a in arrays])
        assert set(got) == set(want)
        for k in got:
            w, o = np.asarray(want[k]), got[k].numpy()
            assert o.shape == w.shape and o.dtype == np.float32
            if not int8:
                np.testing.assert_allclose(o, w, **TOL, err_msg=k)
            elif k == "embedding":
                assert _cosines(o, w).min() >= 0.9999
            else:
                np.testing.assert_allclose(o, w, rtol=0, atol=1e-2, err_msg=k)


@pytest.fixture(scope="module")
def mil_artifacts(cohort):
    tmp, _ = cohort
    return _export_both(tmp, "mil", "mil")


def test_export_mil_matches_jax(mil_artifacts):
    _compare(*mil_artifacts)


def test_export_mil_folded_matches_jax(cohort):
    tmp, _ = cohort
    _compare(*_export_both(tmp, "mil_folded", "mil", fold_bn=True))


def test_export_mil_int8_with_a_shared_qtree_matches_jax(cohort, monkeypatch):
    """Each stack calibrates on its first train batch; the port is handed
    the JAX package's qtree of that batch, converted."""
    from multimodalbrainsurvival_tpu.cli.histo_train import build_datasets as jax_datasets
    from multimodalbrainsurvival_tpu.config import Config as JaxConfig
    from multimodalbrainsurvival_tpu.models import quantize as jq
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
    from multimodalbrainsurvival_tpu.models.folding import fold_resnet_variables

    tmp, states = cohort
    folded = jax.tree.map(np.asarray, fold_resnet_variables(
        torch_mil_to_flax({k: v.numpy() for k, v in states["mil"].items()})))
    jconfig = JaxConfig(dict(_base(tmp), quantize="int8"))
    probe = next(jax_datasets(jconfig, False)["train"].batches(jconfig.batch_size))
    qtree = flax_qtree_to_torch(jq.quantize_mil_resnet(folded, [probe["patch_bag"]],
                                                      arch="resnet18"))
    seen = []

    def shared(resnet, bags, arch):
        seen.append(np.array_equal(np.asarray(bags[0]), probe["patch_bag"]))
        return qtree

    monkeypatch.setattr(_common, "quantize_mil_resnet", shared)
    theirs, ours = _export_both(tmp, "mil_int8", "mil", quantize="int8")
    assert seen == [True]
    _compare(theirs, ours, int8=True)


@pytest.mark.parametrize("kind", ["rna", "feature", "joint"])
def test_export_tables_and_joint_match_jax(cohort, kind):
    tmp, _ = cohort
    _compare(*_export_both(tmp, kind, kind, export_kind=kind))


def test_folded_resnet50_program_runs_k4_through_its_op(tmp_path):
    """A folded Bottleneck program reaches K4 through its custom op (the
    plain blocks on the CPU: 6 a call, whatever the batch) and equals the
    eager model at two batch and bag sizes."""
    config = Config({"model_name": "resnet50", "aggregator": "attention",
                     "aggregator_hdim": 2048})
    model = build_mil_model(config, fold_bn=True).eval()
    model.load_state_dict(_random_state(model, seed=31))
    meta = artifact.export_mil_artifact(model, str(tmp_path / "art"), img_size=IMG)
    program = artifact.load_artifact(str(tmp_path / "art"))
    blocks = []
    plain = fused_stage.fused_block_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_stage, "fused_block_plain",
                   lambda x, blk: blocks.append(1) or plain(x, blk))
        for i, (b, g) in enumerate(((1, 1), (2, 3))):
            x, mask = (torch.from_numpy(a) for a in _inputs(meta, b, g, seed=i))
            got = program.call(x, mask)
            want = artifact.MILServing(model)(x, mask)
            for k in want:
                torch.testing.assert_close(got[k], want[k], **TOL)
    assert len(blocks) == 2 * 2 * 6  # two calls, each program and eager


def test_custom_op_fakes_match_their_implementations():
    """``torch.library.opcheck``: each op's fake gives its implementation's
    shapes, dtypes and strides (CPU tensors: the plain versions)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 16, generator=g)
    w = torch.randn(16, 16, generator=g) / 4
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.bool)
    torch.library.opcheck(ops.attention_pool, (x, w, torch.randn(16, generator=g), mask),
                          test_utils=("test_schema", "test_faketensor"))
    xq = torch.randint(-127, 128, (2, 7, 9, 8), dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (16, 3, 3, 8), dtype=torch.int8, generator=g)
    scale, bias = torch.rand(16, generator=g) * 1e-2, torch.randn(16, generator=g)
    for stride, padding in ((1, 1), (2, 1), (2, 0)):
        torch.library.opcheck(ops.qconv_requant, (xq, wq, scale, bias, stride, padding, True),
                              test_utils=("test_schema", "test_faketensor"))
    r_q = torch.randint(-127, 128, (2, 7, 9, 16), dtype=torch.int8, generator=g)
    s = [torch.tensor(v) for v in (0.05, 0.04, 0.06)]
    torch.library.opcheck(ops.qconv_residual_requant,
                          (xq, wq, scale, bias, r_q, *s, 1, 1),
                          test_utils=("test_schema", "test_faketensor"))
    torch.library.opcheck(ops.stem_requant_pool,
                          (torch.randn(2, 8, 11, 10, generator=g), torch.randn(8, generator=g),
                           torch.tensor(0.02)),
                          test_utils=("test_schema", "test_faketensor"))
    from multimodalbrainsurvival_torch.models.resnet import Bottleneck

    for cin in (16, 32):  # a projection block, then an identity one
        blk = Bottleneck(cin, 8, 1, fold_bn=True).eval()
        for p in blk.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.1
        packed = fused_stage.pack_bottleneck(blk, torch.float32)
        xs = torch.randn(2, cin, 5, 6, generator=g).contiguous(memory_format=torch.channels_last)
        torch.library.opcheck(ops.fused_bottleneck_block, (xs, *packed),
                              test_utils=("test_schema", "test_faketensor"))


# --- serve: the port's server against the JAX server ---------------------------


@pytest.fixture(scope="module")
def servers(cohort, mil_artifacts):
    from multimodalbrainsurvival_tpu.cli import serve as jax_serve

    tmp, _ = cohort
    rna_theirs, rna_ours = _export_both(tmp, "serve_rna", "rna", export_kind="rna")
    urls, srvs = {}, []
    for stack, build, extra in (("jax", jax_serve.build_server, []),
                                ("port", serve.build_server, ["--device", "cpu"])):
        srv = build(["--artifact", f"rna={tmp / f'art_serve_rna_{stack}'}",
                     "--artifact", f"tiles={tmp / f'art_mil_{stack}'}",
                     "--port", "0", "--buckets", "4,8", "--quiet", "1"] + extra)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        urls[stack] = f"http://{srv.server_address[0]}:{srv.server_address[1]}"
        srvs.append(srv)
    yield urls
    for srv in srvs:
        srv.shutdown()
        srv.server_close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_serve_health_and_listing_match_jax(servers):
    got, want = (_get(f"{servers[s]}/healthz") for s in ("port", "jax"))
    assert got[0] == want[0] == 200
    assert got[1]["models"].keys() == want[1]["models"].keys() == {"rna", "tiles"}
    for name in ("rna", "tiles"):
        for key in ("kind", "quantize"):
            assert got[1]["models"][name][key] == want[1]["models"][name][key]
    got, want = (_get(f"{servers[s]}/v1/models") for s in ("port", "jax"))
    for name in ("rna", "tiles"):
        assert (got[1][name]["calling_convention"] == want[1][name]["calling_convention"])
    assert _get(f"{servers['port']}/nope")[0] == 404


def test_serve_lists_and_b64_match_jax(servers):
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(3, GENES)).astype(np.float32)  # padded to bucket 4
    x = rng.integers(0, 255, (5, 3, IMG, IMG, 3), dtype=np.uint8)  # padded to 8
    mask = np.ones((5, 3), np.float32)
    mask[1, -1] = 0.0
    bodies = {"rna": {"data": rows.tolist()},
              "tiles": {"patch_bag": {"b64": base64.b64encode(x.tobytes()).decode(),
                                      "shape": list(x.shape), "dtype": "uint8"},
                        "bag_mask": mask.tolist(), "encoding": "b64"}}
    for name, body in bodies.items():
        (c1, got), (c2, want) = (_post(f"{servers[s]}/v1/models/{name}/score", body)
                                 for s in ("port", "jax"))
        assert c1 == c2 == 200
        assert set(got) == set(want)
        for k in set(got) - {"latency_ms"}:
            if name == "tiles":
                g = np.frombuffer(base64.b64decode(got[k]["b64"]), got[k]["dtype"]).reshape(
                    got[k]["shape"])
                w = np.frombuffer(base64.b64decode(want[k]["b64"]),
                                  want[k]["dtype"]).reshape(want[k]["shape"])
            else:
                g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and g.shape[0] == len(body.get("data", x))
            np.testing.assert_allclose(g, w, **TOL)


def test_serve_bucket_padding_is_invisible(servers, cohort):
    """B=5 pads to bucket 8; the rows equal an unpadded call of the port's
    own program."""
    tmp, _ = cohort
    rows = np.random.default_rng(4).normal(size=(5, GENES)).astype(np.float32)
    code, out = _post(f"{servers['port']}/v1/models/rna/score", {"data": rows.tolist()})
    assert code == 200
    want = artifact.load_artifact(str(tmp / "art_serve_rna_port")).call(torch.from_numpy(rows))
    np.testing.assert_allclose(np.asarray(out["scores"]), want["scores"].numpy(), **TOL)


@pytest.mark.parametrize("model, body, message", [
    ("ghost", {"data": [[0.0]]}, "unknown model"),
    ("rna", {"wrong": [[0.0] * GENES]}, "missing argument 'data'"),
    ("rna", {"data": [0.0] * GENES}, "expected 2 dims"),
    ("rna", {"data": [[0.0] * 5]}, f"dim 1 must be {GENES}"),
    ("rna", {"data": [["x"] * GENES]}, ""),
    ("tiles", {"patch_bag": np.zeros((1, 1, IMG, IMG, 3), np.float32).tolist(),
               "bag_mask": [[1.0]]}, "does not cast"),
    ("tiles", {"patch_bag": np.full((1, 1, IMG, IMG, 3), 300).tolist(), "bag_mask": [[1.0]]},
     "out of range"),
    ("rna", {"data": []}, ""),
], ids=["unknown", "missing", "rank", "width", "strings", "float_pixels", "range", "empty"])
def test_serve_rejects_what_jax_rejects(servers, model, body, message):
    (c1, got), (c2, want) = (_post(f"{servers[s]}/v1/models/{model}/score", body)
                             for s in ("port", "jax"))
    assert c1 == c2 and c1 in (400, 404)
    assert message in got["error"] and message in want["error"]


def test_serve_refuses_an_artifact_of_another_device(mil_artifacts, cohort, monkeypatch):
    tmp, _ = cohort
    monkeypatch.setattr(serve, "resolve_device", lambda name: torch.device("cuda"))
    with pytest.raises(SystemExit, match="exported for cpu.*runs on cuda"):
        serve.build_server(["--artifact", str(tmp / "art_mil_port"), "--port", "0"])


# --- convert_checkpoint ----------------------------------------------------------


def test_convert_checkpoint_matches_the_jax_cli(cohort, tmp_path):
    """A reference-style histo checkpoint (wrapped, with the ResNet's
    1000-class classifier): the port's ``.pt`` through ``torch_mil_to_flax``
    equals the JAX CLI's Orbax checkpoint, leaf for leaf."""
    from multimodalbrainsurvival_tpu.cli import convert_checkpoint as jax_convert
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    _, states = cohort
    ref = dict(states["mil"])
    ref["resnet.fc.weight"] = torch.zeros(1000, 512)
    ref["resnet.fc.bias"] = torch.zeros(1000)
    torch.save({"state_dict": ref}, str(tmp_path / "ref.pt"))
    convert_checkpoint.main(["--torch_path", str(tmp_path / "ref.pt"), "--arch", "histo",
                             "--output", str(tmp_path / "port.pt"), "--device", "cpu"])
    want = jax_convert.convert(str(tmp_path / "ref.pt"), "histo", str(tmp_path / "jax"))
    want = Checkpointer().restore(str(tmp_path / "jax"), want)
    got = torch.load(str(tmp_path / "port.pt"), weights_only=True)
    assert not any(k.startswith("resnet.fc.") for k in got)
    got = torch_mil_to_flax({k: v.numpy() for k, v in got.items()})
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), np.asarray(v))


@pytest.mark.parametrize("arch, source", [("rna", "rna"), ("joint", "joint"),
                                          ("resnet", "mil")])
def test_convert_checkpoint_checks_each_arch(cohort, tmp_path, arch, source):
    _, states = cohort
    state = states[source]
    if arch == "resnet":
        state = {k[len("resnet."):]: v for k, v in state.items() if k.startswith("resnet.")}
    torch.save(state, str(tmp_path / "in.pt"))
    out = convert_checkpoint.convert(str(tmp_path / "in.pt"), arch, str(tmp_path / "out.pt"))
    assert out.keys() == state.keys()
    with pytest.raises(ValueError, match="not a"):
        convert_checkpoint.convert(str(tmp_path / "in.pt"), "histo" if arch != "resnet"
                                   else "rna", str(tmp_path / "bad.pt"))
