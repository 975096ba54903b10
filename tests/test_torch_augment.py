"""Training batches and the train-mode augmentation against the JAX
package, on the CPU.

- ``PatchBagDataset``: after ``n`` calls to ``shuffle()``,
  ``batches(shuffle=True, seed=s, skip_batches=k)`` yields the JAX
  dataset's bags in the JAX order, byte for byte; the producer thread
  stops when the consumer goes away and hands its exceptions over.
- The jitter: ``apply_color_jitter`` fed the draws that the JAX
  ``batched_color_jitter`` makes from a key (reproduced here from the same
  ``jax.random.split``s) matches its output within 1e-5 in float32, alone
  and inside ``preprocess_patches``; ``jitter_draws`` keeps every factor in
  its range and flips at a rate near 0.5.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.data import PatchBagDataset
from multimodalbrainsurvival_torch.ops import image as timage
from multimodalbrainsurvival_tpu.data.patches import PatchBagDataset as JaxDataset
from multimodalbrainsurvival_tpu.ops import image as jimage
from tests.test_torch_histo_cli import IMG, cohort  # noqa: F401

AMOUNTS = (64.0 / 255.0, 0.75, 0.25, 0.04)  # the reference's ColorJitter


def _kw(cohort):  # noqa: F811
    return dict(patch_data_path=str(cohort / "patches"),
                csv_path=str(cohort / "train.csv"), img_size=IMG, bag_size=2,
                max_patches_total=6, keep_remainder=True)


@pytest.mark.parametrize("shuffles,seed,skip", [(0, 3, 0), (1, 1111, 0), (3, 7, 1),
                                                (2, 1112, 3)])
def test_training_batches_match_jax_dataset(cohort, shuffles, seed, skip):  # noqa: F811
    ours, theirs = PatchBagDataset(**_kw(cohort)), JaxDataset(**_kw(cohort))
    for _ in range(shuffles):
        ours.shuffle()
        theirs.shuffle()
    got = list(ours.batches(3, shuffle=True, seed=seed, skip_batches=skip,
                            num_threads=2))
    want = list(theirs.batches(3, shuffle=True, seed=seed, skip_batches=skip,
                               num_threads=2))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for k in ("patch_bag", "bag_mask", "sample_mask", "survival_months",
                  "vital_status"):
            np.testing.assert_array_equal(a[k], b[k])
        assert list(a["WSI"]) == list(b["WSI"]) and list(a["case"]) == list(b["case"])


def test_shuffle_permutes_each_slide_from_the_seed(cohort):  # noqa: F811
    a, b = PatchBagDataset(**_kw(cohort), seed=5), PatchBagDataset(**_kw(cohort), seed=5)
    c = PatchBagDataset(**_kw(cohort), seed=6)
    before = {w: list(e["images"]) for w, e in a.data.items()}
    for ds in (a, b, c):
        ds.shuffle()
    for w, images in before.items():
        assert sorted(map(str, a.data[w]["images"])) == sorted(map(str, images))
        assert a.data[w]["images"] == b.data[w]["images"]
    assert any(a.data[w]["images"] != c.data[w]["images"] for w in before)


def test_abandoned_batches_stop_their_thread(cohort):  # noqa: F811
    ds = PatchBagDataset(**_kw(cohort))
    before = threading.active_count()
    batches = ds.batches(1, prefetch=1, num_threads=1)
    next(batches)
    batches.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_a_reading_error_reaches_the_consumer(cohort, monkeypatch):  # noqa: F811
    ds = PatchBagDataset(**_kw(cohort))

    def broken(idx):
        raise OSError(f"unreadable bag {idx}")

    monkeypatch.setattr(ds, "_load_bag", broken)
    with pytest.raises(OSError, match="unreadable bag"):
        list(ds.batches(2, num_threads=1))


def _jax_draws(key, n):
    """The draws ``batched_color_jitter`` makes from ``key`` (the same
    splits, shapes and ranges), as the port's ``jitter_draws`` returns
    them."""
    b, c, s, h = AMOUNTS
    kb, kc, ks, kh, kf1, kf2 = jax.random.split(key, 6)
    shape4 = (n, 1, 1, 1)

    def uniform(k, lo, hi, shape=shape4):
        return torch.from_numpy(np.asarray(
            jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(n))

    return {
        "flip_h": torch.from_numpy(np.asarray(jax.random.bernoulli(kf1, shape=shape4)).reshape(n)),
        "flip_v": torch.from_numpy(np.asarray(jax.random.bernoulli(kf2, shape=shape4)).reshape(n)),
        "brightness": uniform(kb, max(0.0, 1.0 - b), 1.0 + b),
        "contrast": uniform(kc, max(0.0, 1.0 - c), 1.0 + c),
        "saturation": uniform(ks, max(0.0, 1.0 - s), 1.0 + s),
        "hue": uniform(kh, -h, h, shape4[:3]),
    }


def _images(seed, n=12, hw=9):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, hw, hw + 2, 3), np.uint8)
    u8[0] = 0          # black: hue and saturation undefined
    u8[1] = 128        # grey: delta == 0
    u8[2, ..., 0] = 255  # saturated red channel
    return u8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jitter_core_matches_jax_on_its_draws(seed):
    u8 = _images(seed)
    key = jax.random.PRNGKey(100 + seed)
    want = np.asarray(jimage.batched_color_jitter(
        key, jnp.asarray(u8, jnp.float32) / 255.0, *AMOUNTS))
    draws = _jax_draws(key, len(u8))
    assert draws["flip_h"].any() and not draws["flip_h"].all()
    got = timage.apply_color_jitter(torch.from_numpy(u8).float() / 255.0, draws)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_train_preprocessing_matches_jax_on_its_draws():
    """``preprocess_patches(train=True)``'s chain (/255, jitter, ImageNet
    normalization) against the JAX one, given the JAX draws."""
    u8 = _images(7)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jimage.preprocess_patches(jnp.asarray(u8), train=True, key=key))
    x = torch.from_numpy(u8).to(torch.float32) / torch.tensor(255.0)
    got = timage.normalize_imagenet(timage.apply_color_jitter(x, _jax_draws(key, len(u8))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_hsv_round_trip_matches_jax():
    rgb = _images(3).astype(np.float32) / 255.0
    want = np.asarray(jimage.rgb_to_hsv(jnp.asarray(rgb)))
    hsv = timage.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(), want, rtol=0, atol=1e-6)
    back = timage._hsv_to_rgb_arith(*hsv.unbind(-1))
    np.testing.assert_allclose(back.numpy(), rgb, rtol=0, atol=1e-6)


def test_sampler_ranges_and_flip_rate():
    g = torch.Generator().manual_seed(0)
    n = 20000
    d = timage.jitter_draws(n, g)
    b, c, s, h = AMOUNTS
    for name, lo, hi in (("brightness", 1 - b, 1 + b), ("contrast", 1 - c, 1 + c),
                         ("saturation", 1 - s, 1 + s), ("hue", -h, h)):
        assert d[name].dtype == torch.float32 and d[name].shape == (n,)
        assert lo <= d[name].min() and d[name].max() <= hi, name
        # spread over the range, not stuck at one end
        assert d[name].min() < lo + 0.05 * (hi - lo) and d[name].max() > hi - 0.05 * (hi - lo)
    for name in ("flip_h", "flip_v"):
        assert d[name].dtype == torch.bool
        assert abs(d[name].float().mean().item() - 0.5) < 0.02, name
    # the same seed draws the same; the draws move the generator on
    again = timage.jitter_draws(n, torch.Generator().manual_seed(0))
    assert all(torch.equal(d[k], again[k]) for k in d)
    assert not torch.equal(timage.jitter_draws(n, g)["hue"], d["hue"])


def test_train_preprocessing_needs_a_generator_and_runs_in_dtype():
    u8 = torch.from_numpy(_images(1))
    with pytest.raises(ValueError, match="generator"):
        timage.preprocess_patches(u8, train=True)
    g = torch.Generator().manual_seed(1)
    x = timage.preprocess_patches(u8, dtype=torch.bfloat16, train=True, generator=g)
    assert x.dtype == torch.bfloat16 and x.shape == (12, 3, 9, 11)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert not torch.equal(x, timage.preprocess_patches(u8, dtype=torch.bfloat16))
