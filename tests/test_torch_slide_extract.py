"""The port's streaming slide CLIs (``slide_extractfeatures``,
``slide_joint_savescore``) and ``attention_heatmap`` against the JAX CLIs,
on the CPU (``--device cpu``).

Two synthetic PNG slides (``tests/test_slide_extract.py``'s recipe) of one
case; a ResNet-18 at 64 px. The weights are a port ``state_dict`` saved as
``.pt``; the JAX CLIs get the same numbers through ``torch_mil_to_flax`` /
``torch_joint_to_flax``. Tolerances:

- float32 runs: tile positions equal; per-patch features, slide scores,
  embeddings and attention at ``rtol=1e-4, atol=1e-5`` (the histo serving
  tolerance; the stacks sum in other orders);
- int8 with one qtree (the JAX package's, calibrated on the same first
  tiles, given to the port): scores at ``atol=1e-2`` and slide embeddings
  at cosine ≥ 0.9999 (``tests/test_torch_quantize.py``'s shared-qtree
  bounds); a single patch's features at cosine ≥ 0.999: float32 sums in
  another order move a requantized value by one step now and then, which
  the slide's mean averages down (measured: one patch of 32 at 0.99988);
- ``slide_joint_savescore`` folded: the JAX folded blocks round as the
  float chain, the port's folded encoder is float32 throughout here, so
  ``rtol=1e-4, atol=1e-5`` holds;
- ``attention_heatmap``: the PNG's pixels equal.
"""

import json

import cv2
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import (
    attention_heatmap,
    slide_extractfeatures,
    slide_joint_savescore,
)
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.cli.joint_train import build_joint_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data.tiler import read_png
from multimodalbrainsurvival_torch.models.convert import flax_qtree_to_torch
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

IMG, GENES = 64, 24
TOL = dict(rtol=1e-4, atol=1e-5)


def _make_slide(path: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    slide = np.full((512, 512, 3), 255, np.uint8)
    noise = rng.integers(0, 60, size=(256, 320, 3), dtype=np.uint8)
    slide[128:384, 64:384] = np.array([200, 120, 160], np.uint8) - noise // 2
    cv2.imwrite(path, slide[:, :, ::-1])


def _random_state(model, seed):
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            state[k] = v
        elif k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
            state[k] = torch.tensor(rng.uniform(0.5, 1.5, v.shape), dtype=torch.float32)
        elif k == "aggregator.vector" or v.dim() == 1:
            state[k] = torch.tensor(rng.normal(0.0, 0.1, v.shape), dtype=torch.float32)
        else:
            state[k] = torch.tensor(rng.normal(0.0, 1.0, v.shape) / np.sqrt(v[0].numel()),
                                    dtype=torch.float32)
    return state


def _save_flax(tree, path):
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    Checkpointer().save(path, jax.tree.map(np.asarray, tree), block=True)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from multimodalbrainsurvival_tpu.models.convert import (
        torch_joint_to_flax,
        torch_mil_to_flax,
    )

    tmp = tmp_path_factory.mktemp("slides")
    for i, name in enumerate(("S1", "S2")):
        _make_slide(str(tmp / f"{name}.png"), seed=i)
    pd.DataFrame({"wsi_file_name": ["S1.png", "S2.png"], "case": ["c1", "c1"]}).to_csv(
        tmp / "slides.csv", index=False)
    rng = np.random.default_rng(7)
    joint = pd.DataFrame({"case": ["c1", "c2"], "wsi_file_name": ["S1", "S2"],
                          "survival_months": [12.5, 40.0], "vital_status": [1, 0]})
    for g in range(GENES):
        joint[f"rna_{g}"] = rng.normal(size=2).astype(np.float32)
    joint.to_csv(tmp / "joint.csv", index=False)
    weights = {}
    for agg in ("identity", "attention"):
        model = build_mil_model(Config(_config(tmp, agg)))
        state = _random_state(model, seed=3)
        torch.save(state, str(tmp / f"{agg}.pt"))
        _save_flax(torch_mil_to_flax({k: v.numpy() for k, v in state.items()}),
                   str(tmp / f"{agg}_flax"))
        weights[agg] = state
    jmodel = build_joint_model(Config(_config(tmp, "identity")), in_features=GENES)
    jstate = _random_state(jmodel, seed=5)
    torch.save(jstate, str(tmp / "joint.pt"))
    _save_flax(torch_joint_to_flax({k: v.numpy() for k, v in jstate.items()}),
               str(tmp / "joint_flax"))
    return tmp, weights


def _config(tmp, aggregator, **overrides):
    cfg = {"model_name": "resnet18", "num_classes": 1, "aggregator": aggregator,
           "aggregator_hdim": 512, "img_size": IMG, "batch_size": 8,
           "max_patches_per_slide": 16, "compute_dtype": "float32",
           "slide_csv_path": str(tmp / "slides.csv"), "slide_path": str(tmp),
           "save_patch_features": True}
    cfg.update(overrides)
    return cfg


def _run_both(tmp, name, jax_main, port_main, cfg, port_model, jax_model):
    out = {}
    for stack, main, model, extra in (("jax", jax_main, jax_model, []),
                                      ("port", port_main, port_model, ["--device", "cpu"])):
        c = dict(cfg, model_path=str(tmp / model), output_path=str(tmp / f"{name}_{stack}"))
        path = tmp / f"{name}_{stack}.json"
        path.write_text(json.dumps(c))
        main(["--config", str(path)] + extra)
        out[stack] = tmp / f"{name}_{stack}"
    return out["jax"], out["port"]


@pytest.fixture(scope="module", params=["identity", "attention"])
def float_runs(request, cohort):
    from multimodalbrainsurvival_tpu.cli import slide_extractfeatures as jax_sx

    tmp, _ = cohort
    agg = request.param
    return _run_both(tmp, f"float_{agg}", jax_sx.main, slide_extractfeatures.main,
                     _config(tmp, agg), f"{agg}.pt", f"{agg}_flax")


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def test_slide_extract_float_matches_jax(float_runs):
    jax_dir, port_dir = float_runs
    want = pd.read_csv(jax_dir / "slide_scores.csv")
    got = pd.read_csv(port_dir / "slide_scores.csv")
    assert list(got.columns) == list(want.columns) == ["slide", "case", "n_patches", "score"]
    assert list(got["slide"]) == list(want["slide"]) == ["S1", "S2"]
    assert list(got["n_patches"]) == list(want["n_patches"])
    np.testing.assert_allclose(got["score"], want["score"], **TOL)
    for sid in ("S1", "S2"):
        gp = pd.read_csv(port_dir / "patch_features" / f"{sid}_patches.csv")
        wp = pd.read_csv(jax_dir / "patch_features" / f"{sid}_patches.csv")
        assert list(gp.columns) == list(wp.columns) == ["id", "x", "y", "attention"]
        assert list(zip(gp["x"], gp["y"])) == list(zip(wp["x"], wp["y"]))
        np.testing.assert_allclose(gp["attention"], wp["attention"], **TOL)
        np.testing.assert_allclose(
            np.load(port_dir / "patch_features" / f"{sid}_features.npy"),
            np.load(jax_dir / "patch_features" / f"{sid}_features.npy"), **TOL)
    assert ((port_dir / "pathology_cases_slides.csv").read_text()
            == (jax_dir / "pathology_cases_slides.csv").read_text())
    np.testing.assert_allclose(
        np.loadtxt(port_dir / "pathology_features_slides.csv", delimiter=","),
        np.loadtxt(jax_dir / "pathology_features_slides.csv", delimiter=","), **TOL)


def test_slide_extract_int8_with_a_shared_qtree_matches_jax(cohort, monkeypatch):
    """Each stack calibrates on the first slide's first 8 tiles; the port
    is handed the JAX package's qtree, converted."""
    from multimodalbrainsurvival_tpu.cli import slide_extractfeatures as jax_sx
    from multimodalbrainsurvival_tpu.models import quantize as jq
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
    from multimodalbrainsurvival_tpu.models.folding import fold_resnet_variables

    tmp, weights = cohort
    folded = jax.tree.map(np.asarray, fold_resnet_variables(
        torch_mil_to_flax({k: v.numpy() for k, v in weights["attention"].items()})))
    calibrated = []

    def shared(resnet, bags, arch):
        calibrated.append(np.asarray(bags[0]).shape)
        return flax_qtree_to_torch(jq.quantize_mil_resnet(folded, bags, arch=arch))

    monkeypatch.setattr(slide_extractfeatures, "quantize_mil_resnet", shared)
    jax_dir, port_dir = _run_both(tmp, "int8", jax_sx.main, slide_extractfeatures.main,
                                  _config(tmp, "attention", quantize="int8"),
                                  "attention.pt", "attention_flax")
    assert calibrated == [(8, IMG, IMG, 3)]
    want = pd.read_csv(jax_dir / "slide_scores.csv")
    got = pd.read_csv(port_dir / "slide_scores.csv")
    assert list(got["n_patches"]) == list(want["n_patches"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=0, atol=1e-2)
    for sid in ("S1", "S2"):
        gf = np.load(port_dir / "patch_features" / f"{sid}_features.npy")
        wf = np.load(jax_dir / "patch_features" / f"{sid}_features.npy")
        assert _cosines(gf, wf).min() >= 0.999
    emb = [np.loadtxt(d / "pathology_features_slides.csv", delimiter=",", ndmin=2)
           for d in (port_dir, jax_dir)]
    assert _cosines(*emb).min() >= 0.9999


@pytest.mark.parametrize("fold_bn", [False, True], ids=["float", "folded"])
def test_slide_joint_savescore_matches_jax(cohort, fold_bn):
    from multimodalbrainsurvival_tpu.cli import slide_joint_savescore as jax_sj

    tmp, _ = cohort
    cfg = _config(tmp, "identity", slide_csv_path=str(tmp / "joint.csv"), fold_bn=fold_bn,
                  save_patch_features=False)
    jax_dir, port_dir = _run_both(tmp, f"joint_{fold_bn}", jax_sj.main,
                                  slide_joint_savescore.main, cfg, "joint.pt", "joint_flax")
    want = pd.read_csv(jax_dir / "joint_slide_scores.csv")
    got = pd.read_csv(port_dir / "joint_slide_scores.csv")
    assert list(got.columns) == list(want.columns)
    assert list(got.columns) == ["slide", "case", "n_patches", "score", "survival_months",
                                 "vital_status"]
    for col in ("slide", "case", "n_patches", "survival_months", "vital_status"):
        assert list(got[col]) == list(want[col])
    np.testing.assert_allclose(got["score"], want["score"], **TOL)


@pytest.mark.parametrize("slide, target", [(False, 1024), (True, 1024), (True, 200)],
                         ids=["canvas", "thumbnail", "thumbnail_area_resize"])
def test_attention_heatmap_matches_jax(cohort, float_runs, tmp_path, slide, target):
    """Same ``<slide>_patches.csv`` through both CLIs: equal pixels. At
    ``--target 200`` the 512-px thumbnail is area-resized."""
    from multimodalbrainsurvival_tpu.cli import attention_heatmap as jax_heatmap

    tmp, _ = cohort
    _, port_dir = float_runs
    csv = str(port_dir / "patch_features" / "S1_patches.csv")
    extra = ["--slide", str(tmp / "S1.png")] if slide else []
    extra += ["--target", str(target)]
    attention_heatmap.main(["--patches_csv", csv, "--output", str(tmp_path / "port.png"),
                            "--device", "cpu"] + extra)
    jax_heatmap.main(["--patches_csv", csv, "--output", str(tmp_path / "jax.png")] + extra)
    want = cv2.imread(str(tmp_path / "jax.png"))[:, :, ::-1]
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), want)


def test_pad_slide_bag_is_invisible_to_the_tail(cohort):
    """The tail over one bag padded to 128 equals the unpadded bag's."""
    tmp, weights = cohort
    model = build_mil_model(Config(_config(tmp, "attention"))).eval()
    model.load_state_dict(weights["attention"])
    feats = torch.from_numpy(np.random.default_rng(9).normal(size=(37, 512)).astype(
        np.float32))
    bag, mask = slide_extractfeatures.pad_slide_bag(feats)
    assert bag.shape == (1, 128, 512) and int(mask.sum()) == 37
    emb, scores, att = slide_extractfeatures.make_slide_tail(model)(feats)
    with torch.inference_mode():
        want_emb, want_att = model.extract_from_feats(feats[None])
        want_scores = model.fc(want_emb)
    torch.testing.assert_close(emb, want_emb[0], **TOL)
    torch.testing.assert_close(scores, want_scores[0], **TOL)
    torch.testing.assert_close(att, want_att[0], **TOL)
