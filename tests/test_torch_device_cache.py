"""The port's device cache (``data/device_cache.py``), on the CPU.

The single-device cases of ``tests/test_device_cache.py``: the cached
batches hold the port's host loader's content (pixels, masks, labels, the
``WSI`` and ``case`` lists, the joint dataset's RNA vectors; padding zero)
and the JAX cache's, in index order, shuffled and after ``skip_batches``;
``shuffle()`` re-permutes each slide's patches as the host loader's does;
labels are the union over the slides; the budget falls back as the JAX
one does. ``histo_train`` with and without the cache ends with the same
weights and frames; a ``mesh`` of 2 with the cache in a world of one
process raises naming the launcher, as any such mesh does (the
mesh-sharded cache: ``tests/test_torch_parallel_cache.py``).
"""

import os

import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.cli import histo_train
from multimodalbrainsurvival_torch.data import PatchBagDataset, PatchBagRNADataset
from multimodalbrainsurvival_torch.data.device_cache import (
    DeviceCachedPatchBags,
    cache_bytes,
    cache_fits,
    maybe_cache_datasets,
    maybe_cache_on_device,
)
from multimodalbrainsurvival_tpu.data import PatchBagDataset as JaxPatchBagDataset
from multimodalbrainsurvival_tpu.data import PatchBagRNADataset as JaxPatchBagRNADataset
from multimodalbrainsurvival_tpu.data.device_cache import (
    DeviceCachedPatchBags as JaxDeviceCachedPatchBags,
)
from tests.helpers import make_patch_dir, make_survival_csv
from tests.test_torch_histo_train import _config, _run, _write, few_threads  # noqa: F401
from tests.test_torch_histo_train import cohort as train_cohort  # noqa: F401
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

CPU = torch.device("cpu")
LABELS = ("survival_months", "vital_status")


@pytest.fixture
def cohort(tmp_path):
    root = tmp_path / "patches"
    for i, w in enumerate(["A", "B", "C"]):
        make_patch_dir(str(root), w, 5 + 2 * i, img_size=16, seed=i)
    csv = tmp_path / "ffpe.csv"
    make_survival_csv(str(csv), ["c1", "c2", "c3"], wsi_names=["A.svs", "B.svs", "C.svs"])
    return str(root), str(csv)


def _host(batch, key):
    value = batch[key]
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _assert_same_batches(got, want, keys=("patch_bag", "bag_mask", "sample_mask") + LABELS):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_array_equal(_host(g, k), np.asarray(w[k]), err_msg=k)
        assert g["WSI"] == list(w["WSI"]) and g["case"] == list(w["case"])
        np.testing.assert_array_equal(g["host_sample_mask"], np.asarray(w["sample_mask"]))
        for k in LABELS:
            np.testing.assert_array_equal(g["host_" + k], np.asarray(w[k]))


@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 11)])
def test_cached_batches_match_host_loader_and_jax_cache(cohort, shuffle, seed):
    root, csv = cohort
    base = PatchBagDataset(root, csv, img_size=16, bag_size=2, max_patches_total=100)
    cached = DeviceCachedPatchBags(base, CPU)
    assert len(cached) == len(base)
    assert cached.nbytes == cache_bytes(base) + 16 * 16 * 3  # and one zero row
    got = list(cached.batches(3, shuffle=shuffle, seed=seed))
    _assert_same_batches(got, list(base.batches(3, shuffle=shuffle, seed=seed, num_threads=1)))
    jax_base = JaxPatchBagDataset(root, csv, img_size=16, bag_size=2, max_patches_total=100,
                                  decoder="cv2")
    _assert_same_batches(got, list(JaxDeviceCachedPatchBags(jax_base).batches(
        3, shuffle=shuffle, seed=seed)))


def test_cached_skip_batches_matches_suffix(cohort):
    root, csv = cohort
    cached = DeviceCachedPatchBags(
        PatchBagDataset(root, csv, img_size=16, bag_size=2, max_patches_total=100), CPU)
    full = list(cached.batches(3, shuffle=True, seed=11))
    tail = list(cached.batches(3, shuffle=True, seed=11, skip_batches=2))
    assert len(tail) == len(full) - 2
    for f, t in zip(full[2:], tail):
        assert torch.equal(f["patch_bag"], t["patch_bag"])
        assert f["WSI"] == t["WSI"]


def test_cached_shuffle_repermutes_within_slides_as_the_host_loader(cohort):
    """Each slide's rows are a new permutation of the same set, and the
    epoch's batches are those of a host loader shuffled alike."""
    root, csv = cohort
    kw = dict(img_size=16, bag_size=2, max_patches_total=100, seed=4)
    cached = DeviceCachedPatchBags(PatchBagDataset(root, csv, **kw), CPU)
    host = PatchBagDataset(root, csv, **kw)
    before = {w: ids.copy() for w, ids in cached.ids.items()}
    for _ in range(2):
        cached.shuffle()
        host.shuffle()
    assert any(not np.array_equal(before[w], cached.ids[w]) for w in before)
    for w in before:
        assert sorted(before[w]) == sorted(cached.ids[w])
    _assert_same_batches(list(cached.batches(3, shuffle=True, seed=2)),
                         list(host.batches(3, shuffle=True, seed=2, num_threads=1)))


def test_cached_joint_dataset_carries_rna(cohort, tmp_path):
    root, _ = cohort
    csv = tmp_path / "joint.csv"
    make_survival_csv(str(csv), ["c1", "c2", "c3"], wsi_names=["A.svs", "B.svs", "C.svs"],
                      n_rna=8)
    kw = dict(img_size=16, bag_size=2, max_patches_total=100)
    cached = DeviceCachedPatchBags(PatchBagRNADataset(root, str(csv), **kw), CPU)
    assert cached.rna_dim == 8
    got = list(cached.batches(4))
    keys = ("patch_bag", "bag_mask", "sample_mask", "rna_data") + LABELS
    _assert_same_batches(got, list(PatchBagRNADataset(root, str(csv), **kw).batches(
        4, num_threads=1)), keys)
    jax_cached = JaxDeviceCachedPatchBags(
        JaxPatchBagRNADataset(root, str(csv), decoder="cv2", **kw))
    _assert_same_batches(got, list(jax_cached.batches(4)), keys)


def test_cached_scalar_keys_union_across_slides(cohort):
    """A label only the later slides carry is in every cached batch, 0 on
    the first slide."""
    root, csv = cohort
    base = PatchBagDataset(root, csv, img_size=16, bag_size=2, max_patches_total=100)
    wsis = list(base.data)
    for w in wsis[1:]:
        base.data[w]["survival_bin"] = 3
    cached = DeviceCachedPatchBags(base, CPU)
    assert "survival_bin" in cached._scalar_keys
    got = {}
    for batch in cached.batches(3):
        for wsi, sb, m in zip(batch["WSI"], batch["survival_bin"].numpy(),
                              batch["sample_mask"].numpy()):
            if m:
                got.setdefault(wsi, set()).add(int(sb))
        np.testing.assert_array_equal(batch["host_survival_bin"], batch["survival_bin"])
    for wsi, values in got.items():
        assert values == ({0} if wsi == wsis[0] else {3})


def test_maybe_cache_falls_back_when_too_large(cohort, capsys):
    root, csv = cohort
    base = PatchBagDataset(root, csv, img_size=16, bag_size=2, max_patches_total=100)
    assert cache_fits(base, 1 << 30) and not cache_fits(base, 100)
    assert maybe_cache_on_device(base, True, device=CPU, max_bytes=100) is base
    assert "falling back to the host loader" in capsys.readouterr().out
    assert isinstance(maybe_cache_on_device(base, True, device=CPU, max_bytes=1 << 30),
                      DeviceCachedPatchBags)
    assert maybe_cache_on_device(base, False, device=CPU) is base


def test_cached_padding_matches_host_loader_zeros(cohort):
    """Remainder bags and the partial last batch are zero, as the host
    loader's."""
    root, csv = cohort
    kw = dict(img_size=16, bag_size=3, max_patches_total=100, keep_remainder=True)
    got = list(DeviceCachedPatchBags(PatchBagDataset(root, csv, **kw), CPU).batches(3))
    _assert_same_batches(got, list(PatchBagDataset(root, csv, **kw).batches(3, num_threads=1)))
    masks = [(g["bag_mask"].numpy(), g["sample_mask"].numpy()) for g in got]
    assert any((~bm[sm]).any() for bm, sm in masks)  # a partial bag
    assert any((~sm).any() for _, sm in masks)       # a partial batch


def test_maybe_cache_datasets_shared_budget(cohort, capsys):
    root, csv = cohort

    def mk():
        return PatchBagDataset(root, csv, img_size=16, bag_size=2, max_patches_total=100)

    datasets = {"train": mk(), "val": mk(), "test": mk()}
    per_split = cache_bytes(datasets["train"])
    every = maybe_cache_datasets(dict(datasets), True, device=CPU, max_bytes=3 * per_split)
    assert all(isinstance(d, DeviceCachedPatchBags) for d in every.values())
    train_only = maybe_cache_datasets(dict(datasets), True, device=CPU,
                                      max_bytes=2 * per_split)
    assert isinstance(train_only["train"], DeviceCachedPatchBags)
    assert train_only["val"] is datasets["val"]
    assert "caching only 'train'" in capsys.readouterr().out
    assert maybe_cache_datasets(dict(datasets), True, device=CPU,
                                max_bytes=10)["train"] is datasets["train"]
    assert maybe_cache_datasets(dict(datasets), False, device=CPU) == datasets


def test_cached_batches_match_host_loader_odd_row_and_shards(tmp_path):
    """10-px patches (a row of 300 bytes), one slide from a packed shard."""
    from multimodalbrainsurvival_torch.data.tiler import pack_patch_dir

    root = tmp_path / "p10"
    for i, w in enumerate(["A", "B"]):
        make_patch_dir(str(root), w, 5, img_size=10, seed=i)
    pack_patch_dir(str(root / "B"))
    csv = tmp_path / "c10.csv"
    make_survival_csv(str(csv), ["c1", "c2"], wsi_names=["A.svs", "B.svs"])
    kw = dict(img_size=10, bag_size=2, max_patches_total=5)
    base = PatchBagDataset(str(root), str(csv), **kw)
    assert base.data["B"]["packed_path"] and not base.data["A"]["packed_path"]
    _assert_same_batches(list(DeviceCachedPatchBags(base, CPU).batches(3)),
                         list(PatchBagDataset(str(root), str(csv), **kw).batches(
                             3, num_threads=1)))


def test_histo_train_with_the_cache_ends_with_the_host_loaders_weights(
        train_cohort, tmp_path, few_threads):  # noqa: F811
    """Two train steps (augmentation on: the same draws on the same pixels)
    and the evals: the same weights and frames with and without the
    cache."""
    weights, frames = {}, {}
    for name, cache in (("host", False), ("cached", True)):
        cfg = _config(train_cohort, tmp_path / name, num_epochs=1, augment=True,
                      max_patch_per_wsi_train=2, cache_patches_on_device=cache)
        log = _run(histo_train.main, ["--config", _write(tmp_path / f"{name}.json", cfg),
                                      "--device", "cpu"])
        assert ("cache_patches_on_device:" in log) == cache
        assert log.count("train | epoch 0 | step") == 1  # log_interval 2: 2 steps
        out = tmp_path / name
        weights[name] = torch.load(out / "models/histo_model/model_last.pt", weights_only=True)
        frames[name] = (out / "outputs/histo_model/test_output_last.csv").read_text()
    assert weights["host"].keys() == weights["cached"].keys()
    for k in weights["host"]:
        assert torch.equal(weights["host"][k], weights["cached"][k]), k
    assert frames["host"] == frames["cached"]


def test_a_mesh_with_the_cache_raises_naming_item_7(train_cohort, tmp_path):  # noqa: F811
    cfg = _config(train_cohort, tmp_path / "m", cache_patches_on_device=True,
                  mesh={"dp": 2, "mp": 1})
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node"):
        histo_train.main(["--config", _write(tmp_path / "m.json", cfg), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "m" / "outputs")
