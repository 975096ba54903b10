"""Sharded slide streaming (``slide_extractfeatures``,
``slide_joint_savescore`` under ``mesh: {"dp": 2}``) in a gloo world of 2
processes on the CPU.

``tests/test_torch_slide_extract.py``'s two PNG slides and ResNet-18 at
64 px, 13 tiles a slide in batches of 8 (each rank encodes 4 rows of a
batch; the second batch is partial). One world streams the float
attention model, the int8 one (calibrated on rank 0; rank 1 would
calibrate with doubled abs-maxes), the joint model (``fold_bn: true``) and
the float model on the same slides as JPEG-tiled ``.svs`` pyramids
(``tests/test_torch_tiff.py``'s writer; Photometric YCbCr, which the JAX
package's libtiff reader decodes as the port does); here, while it works, the test process makes the
port's world-of-one runs and the JAX CLIs' on a virtual mesh of 2 devices.
Rank 0 alone writes. Tolerances: the int8 frames bit for bit against the
world of one (rank 0's qtree on both ranks; int8 products are exact); the
float frames against the world of one at ``rtol=1e-5, atol=1e-6`` (the
extract tolerance of ``tests/test_torch_parallel_histo.py``: the
convolutions see batches of another size) and
against the JAX package at that module's ``rtol=1e-4, atol=1e-5``; the
int8 slide embeddings against the JAX package (each stack calibrating on
its own) at a cosine of 0.999, as
``tests/test_torch_quantize.py::test_int8_cli_frames_track_jax`` holds its
features.
"""

import json
import shutil

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import slide_extractfeatures, slide_joint_savescore
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.cli.joint_train import build_joint_model
from multimodalbrainsurvival_torch.cli.slide_extractfeatures import check_mesh_batch
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import tiff
from multimodalbrainsurvival_torch.parallel.mesh import BatchPut, Mesh
from tests import _torch_parallel_worker as worker
from tests import test_torch_slide_extract as sx
from tests.test_torch_parallel_rna import _write_json
from tests.test_torch_tiff import _write_jpeg_slide

DP = {"dp": 2}
W1 = 1e-5, 1e-6
#: the world's jobs: name → (cli, config overrides)
JOBS = {
    "float": ("slide_extractfeatures", {}),
    "int8": ("slide_extractfeatures", {"quantize": "int8"}),
    "joint": ("slide_joint_savescore", {"fold_bn": True,
                                        "slide_csv_path": "joint.csv"}),
    # the same slides as JPEG-tiled .svs pyramids (the port's TIFF reader)
    "jpeg": ("slide_extractfeatures", {"slide_csv_path": "jpeg_slides.csv"}),
}
MODELS = {"float": "attention", "int8": "attention", "joint": "joint", "jpeg": "attention"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _slides(tmp):
    from multimodalbrainsurvival_tpu.models.convert import (
        torch_joint_to_flax,
        torch_mil_to_flax,
    )

    for i, name in enumerate(("S1", "S2")):
        sx._make_slide(str(tmp / f"{name}.png"), seed=i)
        _write_jpeg_slide(str(tmp / f"{name}.svs"),
                          cv2.imread(str(tmp / f"{name}.png"))[:, :, ::-1], tiff.YCBCR)
    for csv, ext in (("slides.csv", "png"), ("jpeg_slides.csv", "svs")):
        pd.DataFrame({"wsi_file_name": [f"S1.{ext}", f"S2.{ext}"],
                      "case": ["c1", "c1"]}).to_csv(tmp / csv, index=False)
    rng = np.random.default_rng(7)
    joint = pd.DataFrame({"case": ["c1", "c2"], "wsi_file_name": ["S1", "S2"],
                          "survival_months": [12.5, 40.0], "vital_status": [1, 0]})
    for g in range(sx.GENES):
        joint[f"rna_{g}"] = rng.normal(size=2).astype(np.float32)
    joint.to_csv(tmp / "joint.csv", index=False)
    cfg = Config(sx._config(tmp, "attention"))
    for name, model, to_flax in (
            ("attention", build_mil_model(cfg), torch_mil_to_flax),
            ("joint", build_joint_model(cfg, in_features=sx.GENES), torch_joint_to_flax)):
        state = sx._random_state(model, seed=3)
        torch.save(state, str(tmp / f"{name}.pt"))
        sx._save_flax(to_flax({k: v.numpy() for k, v in state.items()}),
                      str(tmp / f"{name}_flax"))


def _config(tmp, name, stack="port", **overrides):
    cli, base = JOBS[name]
    cfg = sx._config(tmp, "attention", **{**base, **overrides})
    if "slide_csv_path" in base:
        cfg["slide_csv_path"] = str(tmp / base["slide_csv_path"])
    cfg.update(max_patches_per_slide=13, save_patch_features=False,
               model_path=str(tmp / (MODELS[name] + ("_flax" if stack == "jax" else ".pt"))))
    tag = f"{name}_{stack}" + ("_dp" if cfg.get("mesh") else "")
    cfg["output_path"] = str(tmp / tag)
    return _write_json(tmp / f"{tag}.json", cfg)


def _references(tmp):
    from multimodalbrainsurvival_tpu.cli import slide_extractfeatures as jax_sx
    from multimodalbrainsurvival_tpu.cli import slide_joint_savescore as jax_sj

    port = {"slide_extractfeatures": slide_extractfeatures.main,
            "slide_joint_savescore": slide_joint_savescore.main}
    jax = {"slide_extractfeatures": jax_sx.main, "slide_joint_savescore": jax_sj.main}
    for name, (cli, _) in JOBS.items():
        port[cli](["--config", _config(tmp, name), "--device", "cpu"])
        jax[cli](["--config", _config(tmp, name, "jax", mesh=DP)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_stream")
    _slides(tmp)
    # rank 1 would quantize with doubled abs-maxes if it calibrated itself
    jobs = [{"cli": cli, "argv": ["--config", _config(tmp, name, mesh=DP), "--device", "cpu"],
             "skew_rank": 1} for name, (cli, _) in JOBS.items()]
    out = tmp / "codes"
    out.mkdir()
    results, _ = worker.run_world(2, _write_json(tmp / "jobs.json", jobs), str(out),
                                  str(tmp / "logs"), lambda: _references(tmp))
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{log[-3000:]}"
    yield tmp
    shutil.rmtree(tmp, ignore_errors=True)


def _frames(directory):
    """The streaming CLI's frames in ``directory``: name → DataFrame, and the
    case-level features as an array."""
    out = {p.name: pd.read_csv(p) for p in sorted(directory.glob("*slide*scores*.csv"))}
    feats = directory / "pathology_features_slides.csv"
    if feats.exists():
        out["features"] = np.loadtxt(feats, delimiter=",", ndmin=2)
    return out


def _assert_frames(got: dict, want: dict, rtol=None, atol=None, cosine=None):
    assert got.keys() == want.keys() and got
    for name, w in want.items():
        g = got[name]
        if name == "features":
            if cosine is not None:
                assert sx._cosines(g, w).min() >= cosine
            elif rtol is None:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
            continue
        assert list(g.columns) == list(w.columns)
        assert list(g["slide"]) == list(w["slide"]) == ["S1", "S2"]
        assert list(g["n_patches"]) == list(w["n_patches"]) == [13, 13]
        if cosine is not None:
            continue
        if rtol is None:
            pd.testing.assert_frame_equal(g, w, check_exact=True)
        else:
            np.testing.assert_allclose(g["score"], w["score"], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_streaming_under_dp_equals_the_world_of_one(world, name):
    tol = {} if name == "int8" else dict(zip(("rtol", "atol"), W1))
    _assert_frames(_frames(world / f"{name}_port_dp"), _frames(world / f"{name}_port"), **tol)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_streaming_under_dp_tracks_jax_on_a_virtual_mesh(world, name):
    tol = {"cosine": 0.999} if name == "int8" else dict(zip(("rtol", "atol"),
                                                           (sx.TOL["rtol"], sx.TOL["atol"])))
    _assert_frames(_frames(world / f"{name}_port_dp"), _frames(world / f"{name}_jax_dp"), **tol)


def test_a_batch_that_does_not_split_over_dp_raises_at_start_up():
    put = BatchPut(Mesh(dp=2, mp=1, rank=0, device=torch.device("cpu"), backend=None))
    with pytest.raises(ValueError, match="batch_size 7 must be divisible by dp=2"):
        check_mesh_batch(put, 7)
    check_mesh_batch(put, 8)
    check_mesh_batch(None, 7)
