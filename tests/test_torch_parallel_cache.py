"""The mesh-sharded device cache (``data/device_cache.py``) in a gloo world
of 2 processes on the CPU.

One world runs this module's jobs in order (``_torch_parallel_worker.py``):
the cache over ``{"dp": 2}`` and over ``{"dp": 1, "mp": 2, "shard_bag":
true}`` on a cohort of slides of 3-7 patches (bags of 2, a padded last
batch; ``cache_check``), then ``histo_train`` with
``cache_patches_on_device: true`` under both meshes. Each rank holds its
block of the cohort's rows, and each placed batch of two epochs (the
second after ``shuffle()``) must equal the host loader's placed by
``BatchPut``, bit for bit, its lists and ``host_*`` mirrors too. The first
epoch's pixels, gathered over the ranks, must equal the JAX package's
mesh-sharded cache on a virtual mesh of the same shape (JAX
``tests/test_device_cache.py:278-382``; its ``shuffle()`` draws from a
generator of its own, so the second epoch is held to the host loader
alone). The budget is one rank's times the world; ``bag_size`` must divide
over ``mp`` under ``shard_bag`` and ``batch_size`` over ``dp``, with the
JAX package's errors. The train runs' first steps are held against the
port's world-of-one run on the host loader as
``tests/test_torch_parallel_histo.py`` holds a train-mode BatchNorm run
(twice the synced-statistics witness's distance; the JAX tolerance below
it).
"""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from tests import _torch_parallel_worker as worker
from tests import test_torch_parallel_histo as histo
from tests.test_torch_parallel_rna import _assert_grads_close, _write_json

MESHES = {"dp": histo.DP, "bag": histo.BAG}
#: the world's train jobs: name → config overrides
TRAIN = {f"train_{name}": {"mesh": mesh, "cache_patches_on_device": True}
         for name, mesh in MESHES.items()}
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cache_cohort(tmp):
    """Five slides of 3-7 patches (bags of 2 with remainders dropped, a
    padded last batch of ``BATCH``)."""
    root = tmp / "cache_patches"
    wsis = [f"S{i}" for i in range(5)]
    for i, w in enumerate(wsis):
        histo._patches(str(root), w, 3 + i, seed=80 + i)
    rng = np.random.default_rng(4)
    pd.DataFrame({"case": [f"k{i}" for i in range(5)],
                  "survival_months": rng.uniform(1, 120, 5).round(4),
                  "vital_status": [1, 0, 1, 1, 0],
                  "wsi_file_name": [f"{w}.svs" for w in wsis]}).to_csv(
        tmp / "cache.csv", index=False)
    return str(root), str(tmp / "cache.csv")


def _jax_cached_pixels(root, csv, mesh):
    """The JAX mesh-sharded cache's first-epoch ``patch_bag`` batches on a
    virtual mesh of ``mesh``'s shape (no in-slide shuffle)."""
    from multimodalbrainsurvival_tpu.data import PatchBagDataset
    from multimodalbrainsurvival_tpu.data.device_cache import DeviceCachedPatchBags
    from multimodalbrainsurvival_tpu.parallel import make_mesh

    base = PatchBagDataset(root, csv, img_size=histo.IMG, bag_size=2, max_patches_total=100)
    cached = DeviceCachedPatchBags(base, mesh=make_mesh(dp=mesh["dp"], mp=mesh.get("mp", 1)),
                                   shard_bag=mesh.get("shard_bag", False))
    return [np.asarray(b["patch_bag"]) for b in cached.batches(BATCH, shuffle=True, seed=0)]


def _references(tmp, root, csv):
    refs = {name: _jax_cached_pixels(root, csv, mesh) for name, mesh in MESHES.items()}
    for tag, patch in (("w1", None), ("witness", worker.synced_statistics)):
        record = {}
        argv = histo._argv(histo._config(tmp, f"train_{tag}", augment=False))
        if patch is None:
            assert worker.run_cli("histo_train", argv, record) == 0
        else:
            with patch():
                assert worker.run_cli("histo_train", argv, record) == 0
        refs[tag] = record
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cache")
    histo._cohort(tmp)
    root, csv = _cache_cohort(tmp)
    jobs = [{"cache": {"mesh": mesh, "root": root, "csv": csv, "bag": 2, "img": histo.IMG,
                       "batch": BATCH, "out": str(tmp / f"cache_{name}_")}}
            for name, mesh in MESHES.items()]
    jobs += [{"cli": "histo_train", "argv": histo._argv(histo._config(
        tmp, name, augment=False, **overrides)), "grads": str(tmp / f"{name}.grads.pt")}
        for name, overrides in TRAIN.items()]
    histo._initial_weights(tmp, "train_dp")
    out = tmp / "codes"
    out.mkdir()
    results, refs = worker.run_world(2, _write_json(tmp / "jobs.json", jobs), str(out),
                                     str(tmp / "logs"), lambda: _references(tmp, root, csv))
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{log[-3000:]}"
    yield tmp, refs
    shutil.rmtree(tmp, ignore_errors=True)


def _reports(tmp, name):
    return [json.loads((tmp / f"cache_{name}_{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_cache_batches_equal_the_host_loaders(world, name):
    tmp, _ = world
    for report in _reports(tmp, name):
        assert report["mismatches"] == []
        assert report["batches"] == 6  # 2 epochs of 3 batches, the last padded


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_cache_pixels_equal_jax_on_a_virtual_mesh(world, name):
    tmp, refs = world
    parts = [np.load(str(tmp / f"cache_{name}_{r}.npz")) for r in range(2)]
    axis = 1 if MESHES[name].get("shard_bag") else 0
    got = [np.concatenate([p[f"arr_{i}"] for p in parts], axis=axis)
           for i in range(len(parts[0].files))]
    want = refs[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_cache_budget_is_the_worlds(world, name):
    """Each rank holds its block of rows (half the cohort); a budget of half
    the cohort a rank caches it over the world and falls back alone."""
    tmp, _ = world
    reports = _reports(tmp, name)
    cohort = reports[0]["cohort_bytes"]
    row = histo.IMG * histo.IMG * 3
    assert [r["nbytes"] for r in reports] == [-(-cohort // row // 2) * row,
                                              cohort - -(-cohort // row // 2) * row]
    assert all(r["cached"] and not r["cached_alone"] for r in reports)


def test_sharded_cache_refuses_a_bag_or_batch_that_does_not_split(world):
    tmp, _ = world
    bag, dp = _reports(tmp, "bag")[0], _reports(tmp, "dp")[0]
    assert "shard_bag cache needs bag_size (3) divisible by the mesh's mp axis (2)" in \
        bag["bag_error"]
    assert dp["bag_error"] is None  # no bag sharding: any bag
    assert "batch_size (3) divisible by the mesh's dp axis (2)" in dp["batch_error"]


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_cached_train_under_a_mesh_matches_the_world_of_one(world, name):
    tmp, refs = world
    got = torch.load(str(tmp / f"{name}.grads.pt"))
    want, witness = refs["w1"], refs["witness"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    floor = 2 * max(float((witness["grads"][k] - want["grads"][k]).abs().max())
                    for k in want["grads"])
    _assert_grads_close(got["grads"], want["grads"], floor)
    assert os.path.exists(tmp / "out" / "outputs" / name / "val_output_last.csv")
