"""The port's serving CLIs against the JAX CLIs on one cohort and one set of
weights, on the CPU (``--device cpu``).

The weights are a port ``state_dict`` (reference keys) saved as ``.pt``;
the JAX CLIs get the same numbers through ``torch_mil_to_flax`` +
``Checkpointer().save``, as ``tests/test_golden_inference.py`` does. The
cohort mixes PNG patch directories and packed ``patches.npy`` shards, pads
the last batch, and gives one case two slides. Frames are compared with
``rtol=1e-4`` (``atol=1e-6`` for features near zero). The ``fold_bn`` case
serves a ResNet-50, whose folded stride-1 bottleneck chains go through the
fused-stage kernel K4 (its plain version on the CPU).
"""

import contextlib

import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import (
    histo_extractfeatures,
    histo_savescore,
)
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.kernels import fused_stage
from tests.helpers import make_patch_dir, make_survival_csv
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

IMG = 32
WSIS = [f"H{i}" for i in range(5)]


def _random_state(model, seed):
    """Seeded numpy weights of the right scale for every tensor."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
            continue
        if k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif v.dim() == 1:
            a = rng.normal(0.0, 0.1, v.shape)
        else:
            a = rng.normal(0.0, 1.0, v.shape) / np.sqrt(np.prod(v.shape[1:]))
        state[k] = torch.tensor(a, dtype=torch.float32)
    return state


def _pack(root, wsi):
    """Write the slide's PNGs into a packed shard (newer than loc.txt)."""
    import cv2

    d = os.path.join(root, wsi)
    n = sum(1 for _ in open(os.path.join(d, "loc.txt"))) - 2
    imgs = [cv2.imread(os.path.join(d, f"{wsi}_patch_{i}.png"))[:, :, ::-1]
            for i in range(n)]
    np.save(os.path.join(d, "patches.npy"), np.stack(imgs))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    root = str(tmp / "patches")
    for i, w in enumerate(WSIS):
        make_patch_dir(root, w, 5 + i % 2, img_size=IMG, seed=30 + i)
    for w in WSIS[3:]:
        _pack(root, w)
    splits = {"train": ([0, 1, 2, 3, 4], ["c0", "c1", "c2", "c3", "c4"]),
              "val": ([0, 1], ["c0", "c1"]),
              "test": ([2, 3, 4], ["c2", "c3", "c3"])}  # c3 has two slides
    for split, (idx, cases) in splits.items():
        make_survival_csv(str(tmp / f"{split}.csv"), cases,
                          wsi_names=[f"{WSIS[i]}.svs" for i in idx],
                          seed=len(idx) + len(split))
    return tmp


def _config(cohort, **overrides):
    cfg = {
        "model_name": "resnet18", "num_classes": 1, "batch_size": 3,
        "data_path": str(cohort / "patches"),
        "train_csv_path": str(cohort / "train.csv"),
        "val_csv_path": str(cohort / "val.csv"),
        "test_csv_path": str(cohort / "test.csv"),
        "num_workers": 1, "img_size": IMG,
        "train_bag_size": 2, "val_bag_size": 2,
        "max_patch_per_wsi_train": 5, "max_patch_per_wsi_val": 5,
        "aggregator": "attention", "aggregator_hdim": 512,
        "task": "survival_prediction", "flag": "cli_parity",
    }
    cfg.update(overrides)
    return cfg


def _run_both(cohort, tmp, aggregator, fold_bn, **overrides):
    cfg = _config(cohort, aggregator=aggregator, fold_bn=fold_bn, **overrides)
    model = build_mil_model(Config(cfg))
    pt = tmp / "init.pt"
    torch.save(_random_state(model, seed=11), str(pt))

    from multimodalbrainsurvival_tpu.cli import (
        histo_extractfeatures as jax_extract,
        histo_savescore as jax_savescore,
    )
    from multimodalbrainsurvival_tpu.models.convert import (
        load_torch_state_dict,
        torch_mil_to_flax,
    )
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    flax_dir = str(tmp / "init_flax")
    Checkpointer().save(
        flax_dir,
        jax.tree.map(np.asarray, torch_mil_to_flax(load_torch_state_dict(str(pt)))),
        block=True,
    )
    for name, main, model_path, extra in [
        ("jax", jax_savescore.main, flax_dir, []),
        ("jax", jax_extract.main, flax_dir, []),
        ("torch", histo_savescore.main, str(pt), ["--device", "cpu"]),
        ("torch", histo_extractfeatures.main, str(pt), ["--device", "cpu"]),
    ]:
        c = dict(cfg, model_path=model_path, output_path=str(tmp / name))
        p = tmp / f"{name}_{main.__module__.rsplit('.', 1)[-1]}.json"
        p.write_text(json.dumps(c))
        main(["--config", str(p)] + extra)
    return tmp / "jax", tmp / "torch"


@contextlib.contextmanager
def _count_k4_blocks():
    """Counts the blocks K4's plain version runs (the CPU's K4 launches)."""
    calls = []
    plain = fused_stage.fused_block_plain

    def counting(x, blk):
        calls.append(tuple(x.shape))
        return plain(x, blk)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_stage, "fused_block_plain", counting)
        yield calls


@pytest.fixture(scope="module", params=[("identity", False, "resnet18"),
                                        ("attention", False, "resnet18"),
                                        ("attention", True, "resnet50")],
                ids=["identity", "attention", "attention_fold_bn"])
def outputs(request, cohort, tmp_path_factory):
    """(JAX output dir, port output dir, feature width, K4 blocks run)."""
    aggregator, fold_bn, arch = request.param
    tmp = tmp_path_factory.mktemp("run")
    dim = 2048 if arch == "resnet50" else 512
    with _count_k4_blocks() as k4_blocks:
        jax_dir, torch_dir = _run_both(cohort, tmp, aggregator, fold_bn,
                                       model_name=arch, aggregator_hdim=dim)
    return jax_dir, torch_dir, dim, len(k4_blocks)


def test_fold_bn_serving_runs_k4(outputs):
    """The folded ResNet-50 goes through K4 (6 blocks per batch: layer1 and
    layer2's stride-1 tail); the unfolded ResNet-18s never do."""
    jax_dir, torch_dir, dim, k4_blocks = outputs
    if dim == 2048:
        assert k4_blocks > 0 and k4_blocks % 6 == 0
    else:
        assert k4_blocks == 0


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_savescore_frames_match_jax(outputs, split):
    jax_dir, torch_dir, _, _ = outputs
    want = pd.read_csv(jax_dir / f"init_flax_pathology_{split}_df.csv", index_col=0)
    got = pd.read_csv(torch_dir / f"init.pt_pathology_{split}_df.csv", index_col=0)
    assert list(got.columns) == ["id", "score", "survival_months", "vital_status"]
    assert list(got.index) == list(want.index)
    assert list(got["id"]) == list(want["id"])
    assert np.isfinite(got["score"]).all()
    for col in ("score", "survival_months", "vital_status"):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_extractfeatures_frames_match_jax(outputs, split):
    jax_dir, torch_dir, dim, _ = outputs
    want_cases = pd.read_csv(jax_dir / f"pathology_cases_{split}.csv", index_col=0)
    got_cases = pd.read_csv(torch_dir / f"pathology_cases_{split}.csv", index_col=0)
    pd.testing.assert_frame_equal(got_cases, want_cases)
    want = np.loadtxt(jax_dir / f"pathology_features_{split}.csv", delimiter=",")
    got = np.loadtxt(torch_dir / f"pathology_features_{split}.csv", delimiter=",")
    assert got.shape == want.shape == (len(want_cases), dim)
    # near zero, float32 sums in another order move a feature by up to ~1e-6
    # of the features' scale: ResNet-50's reach 15 here, and its stock folded
    # forward (without K4) misses a 1e-6 floor by as much, so its floor
    # scales with them
    atol = 1e-6 * (np.abs(want).max() if dim == 2048 else 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def _batches(ds_cls, **kw):
    return list(ds_cls(**kw).batches(2, num_threads=2))


def _assert_same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for k in ("patch_bag", "bag_mask", "sample_mask", "survival_months",
                  "vital_status"):
            np.testing.assert_array_equal(a[k], b[k])
        assert list(a["WSI"]) == list(b["WSI"]) and list(a["case"]) == list(b["case"])


@pytest.mark.parametrize("keep_remainder", [False, True])
def test_patch_bag_batches_match_jax_dataset(cohort, keep_remainder):
    """PNG and packed-shard slides, bag chunking with and without the
    remainder, the patch cap and the padded last batch, byte for byte."""
    from multimodalbrainsurvival_torch.data import PatchBagDataset
    from multimodalbrainsurvival_tpu.data.patches import PatchBagDataset as JaxDataset

    kw = dict(patch_data_path=str(cohort / "patches"),
              csv_path=str(cohort / "train.csv"), img_size=IMG, bag_size=4,
              max_patches_total=6, keep_remainder=keep_remainder)
    _assert_same_batches(_batches(PatchBagDataset, **kw), _batches(JaxDataset, **kw))


def test_patch_bag_stale_shard_and_bom_csv_match_jax(cohort, tmp_path):
    """A shard older than loc.txt is ignored (the PNGs are read), and a UTF-8
    BOM on the CSV header is stripped."""
    from multimodalbrainsurvival_torch.data import PatchBagDataset
    from multimodalbrainsurvival_tpu.data.patches import PatchBagDataset as JaxDataset

    slide = tmp_path / "patches" / "H3"
    shutil.copytree(cohort / "patches" / "H3", slide)
    shard = np.load(slide / "patches.npy")
    np.save(slide / "patches.npy", np.zeros_like(shard))  # wrong if read
    old = os.path.getmtime(slide / "loc.txt") - 100
    os.utime(slide / "patches.npy", (old, old))
    csv_path = tmp_path / "bom.csv"
    csv_path.write_text("case,survival_months,vital_status,wsi_file_name\n"
                        "c9,12.5,1,H3.svs\n", encoding="utf-8-sig")
    kw = dict(patch_data_path=str(tmp_path / "patches"), csv_path=str(csv_path),
              img_size=IMG, bag_size=2, max_patches_total=6)
    ours = _batches(PatchBagDataset, **kw)
    _assert_same_batches(ours, _batches(JaxDataset, **kw))
    assert ours[0]["patch_bag"][0, 0].any()


def test_bfloat16_path_tracks_float32_on_cpu(cohort, tmp_path):
    """``compute_dtype: bfloat16`` (autocast encoder, bf16 pool inputs) runs
    the same CLI and stays within bf16 rounding of the float32 features."""
    model = build_mil_model(Config(_config(cohort)))
    pt = tmp_path / "init.pt"
    torch.save(_random_state(model, seed=12), str(pt))
    feats = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _config(cohort, compute_dtype=dtype, model_path=str(pt),
                      output_path=str(tmp_path / dtype))
        p = tmp_path / f"{dtype}.json"
        p.write_text(json.dumps(cfg))
        histo_extractfeatures.main(["--config", str(p), "--device", "cpu"])
        feats[dtype] = np.loadtxt(tmp_path / dtype / "pathology_features_val.csv",
                                  delimiter=",")
    a, b = feats["float32"], feats["bfloat16"]
    cos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert a.shape == b.shape and cos.min() > 0.999
