"""Device-resident patch cache: the cohort decoded once, held on the card.

The port's own copy of the single-device part of
``multimodalbrainsurvival_tpu/data/device_cache.py:56-505``. A train
step's batch is ``batch x bag x 224² x 3`` uint8 (12.8 MB at 16 x 16);
held on the card, the cohort is read from the host once, and each step's
bags are a gather on the card driven by a small int32 upload:

- ``DeviceCachedPatchBags`` wraps a ``PatchBagDataset`` (or its joint
  subclass): every patch is read once, through the C++ batch assembler
  (``data/native.py``), in each slide's current patch order, and uploaded
  as one flat ``(N + 1, H, W, 3)`` uint8 tensor whose last row is zero;
- each batch uploads one int32 vector (the batch's ``bag x batch`` cache
  rows, padding pointing at the zero row, then each sample's slide) and
  gathers the pixels (``index_select``), the masks, the slides' labels and,
  for the joint dataset, their RNA vectors from tables on the card;
- the wrapped dataset's index, bag chunking, remainder, zero padding,
  ``skip_batches`` and per-epoch in-slide ``shuffle()`` are kept, so the
  batches are content-identical to the host loader's: ``shuffle()`` calls
  the wrapped dataset's own (its generator, its order) and re-reads the
  slides' orders from it;
- the ``WSI`` and ``case`` lists, and ``host_sample_mask`` and
  ``host_<label>`` numpy mirrors for the loop's host-side reads, come with
  each batch.

``maybe_cache_datasets`` applies one budget to all splits together
(``cache_max_bytes_per_device``, 12 GiB by default): all of them if they
fit, else only ``train`` if it fits, else the host loader, with the JAX
package's messages. The mesh-sharded cache (JAX ``:126-505``) is not
ported yet: under a ``mesh`` over more than one device
``Config.check_ported`` refuses ``cache_patches_on_device`` (ROADMAP.md,
queue 1, item 7b).
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from multimodalbrainsurvival_torch.data.patches import _labels

DEFAULT_MAX_BYTES = 12 << 30


def cache_bytes(base) -> int:
    n = sum(e["n_images"] for e in base.data.values())
    return n * base.img_size * base.img_size * 3


def cache_fits(base, max_bytes: int) -> bool:
    return cache_bytes(base) <= max_bytes


def maybe_cache_on_device(base, enabled: bool, *, device: torch.device,
                          max_bytes: int = DEFAULT_MAX_BYTES, num_threads: int = 8):
    """``base`` held on ``device`` when ``enabled`` and it fits, else
    ``base`` itself."""
    if not enabled:
        return base
    if not cache_fits(base, max_bytes):
        total = sum(e["n_images"] for e in base.data.values())
        print(f"cache_patches_on_device: cohort too large for HBM cache "
              f"({total} patches x {base.img_size}^2x3 > 1 device(s) x {max_bytes} "
              "bytes); falling back to the host loader")
        return base
    return DeviceCachedPatchBags(base, device, num_threads=num_threads)


def maybe_cache_datasets(datasets: dict, enabled: bool, *, device: torch.device,
                         max_bytes: int = DEFAULT_MAX_BYTES, num_threads: int = 8) -> dict:
    """A ``{split: dataset}`` dict under one shared budget: every split held
    on ``device`` if all fit, else only ``train`` if it fits, else none."""
    if not enabled:
        return datasets

    def wrap(ds):
        return DeviceCachedPatchBags(ds, device, num_threads=num_threads)

    total = sum(cache_bytes(ds) for ds in datasets.values())
    if total <= max_bytes:
        return {k: wrap(v) for k, v in datasets.items()}
    train = datasets.get("train")
    if train is not None and cache_fits(train, max_bytes):
        print("cache_patches_on_device: all splits together exceed the HBM budget "
              f"({total} > {max_bytes} bytes); caching only 'train'")
        return {k: wrap(v) if k == "train" else v for k, v in datasets.items()}
    print(f"cache_patches_on_device: cohort too large for HBM cache ({total} > "
          f"{max_bytes} bytes); falling back to the host loader")
    return datasets


class DeviceCachedPatchBags:
    """A patch-bag dataset whose pixels live on ``device``."""

    def __init__(self, base, device: torch.device, *, num_threads: int = 8):
        self.base = base
        self.bag_size = base.bag_size
        self.img_size = base.img_size
        self.device = torch.device(device)
        hw = base.img_size
        wsi_keys = list(base.data)
        counts = [base.data[w]["n_images"] for w in wsi_keys]
        n_total = sum(counts)
        self._zero_row = n_total
        starts = np.cumsum([0] + counts[:-1]).astype(np.int64)

        t0 = time.perf_counter()
        flat = np.zeros((n_total, hw, hw, 3), np.uint8)
        base._read_slots(flat, [(int(s), base.data[w], base.data[w]["images"])
                                for s, w in zip(starts, wsi_keys)], max(1, num_threads))
        t1 = time.perf_counter()
        self._cache = torch.empty((n_total + 1, hw, hw, 3), dtype=torch.uint8,
                                  device=self.device)
        self._cache[:n_total].copy_(torch.from_numpy(flat))
        self._cache[n_total].zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del flat
        self.read_seconds = t1 - t0
        self.upload_seconds = time.perf_counter() - t1
        self.nbytes = self._cache.numel()

        # ids[wsi][j]: the cache row of position j of the slide's patch list
        # (views into one flat array); rows_of maps a patch to its row
        self._ids_flat = np.arange(n_total, dtype=np.int32)
        self.ids = {w: self._ids_flat[s:s + c] for w, s, c in zip(wsi_keys, starts, counts)}
        self._row_of = {w: {item: int(s) + j for j, item in enumerate(base.data[w]["images"])}
                        for w, s in zip(wsi_keys, starts)}

        # per-item and per-slide tables: a batch is a few numpy gathers
        slot_of = {w: i for i, w in enumerate(wsi_keys)}
        self._wsi_names = [base.data[w]["WSI"] for w in wsi_keys]
        self._case_names = [str(base.data[w].get("case", base.data[w]["WSI"]))
                            for w in wsi_keys]
        label_dicts = [_labels(base.data[w]) for w in wsi_keys]
        # a label some slide lacks is 0 there (the union over every slide)
        self._scalar_keys = [k for k in dict.fromkeys(k for d in label_dicts for k in d)
                             if k not in ("WSI", "case")]
        self._scalars = {
            k: np.asarray([d.get(k, 0) for d in label_dicts],
                          np.result_type(*(np.asarray(d[k]).dtype for d in label_dicts
                                           if k in d)))
            for k in self._scalar_keys}
        self._item_slot = np.asarray([slot_of[w] for w, _ in base.index], np.int64)
        self._item_off = np.asarray([off for _, off in base.index], np.int64)
        self._item_len = np.minimum(
            self.bag_size,
            np.asarray([base.data[w]["n_images"] for w, _ in base.index], np.int64)
            - self._item_off)
        self._wsi_base = starts
        self._n_slides = len(wsi_keys)

        def table(values: np.ndarray) -> torch.Tensor:
            # one zero row past the slides: padded samples read it
            out = np.zeros((len(values) + 1,) + values.shape[1:], values.dtype)
            out[:-1] = values
            return torch.from_numpy(out).to(self.device)

        self._dev_scalars = {k: table(v) for k, v in self._scalars.items()}
        self._dev_rna = None
        if any("rna_data" in e for e in base.data.values()):
            self.rna_dim = base.rna_dim
            self._dev_rna = table(np.asarray(
                [np.asarray(base.data[w]["rna_data"], np.float32) for w in wsi_keys]))
        print(f"cache_patches_on_device: {n_total} patches, {self.nbytes} bytes on "
              f"{self.device} (read {self.read_seconds:.2f} s, upload "
              f"{self.upload_seconds:.2f} s)")

    def shuffle(self) -> None:
        """The wrapped dataset's per-epoch in-slide permutation (reference
        ``models.py:269-272``), its new orders read back as cache rows."""
        self.base.shuffle()
        for w, ids in self.ids.items():
            rows = self._row_of[w]
            ids[:] = [rows[item] for item in self.base.data[w]["images"]]

    def __len__(self) -> int:
        return len(self.base.index)

    def batches(self, batch_size: int, *, shuffle: bool = False, seed: int | None = None,
                skip_batches: int = 0, **_: object) -> Iterator[dict]:
        """The host loader's batches (its order, its ``skip_batches``), with
        every array on the device; the host loader's ``num_threads`` and
        ``prefetch`` mean nothing here."""
        order = np.arange(len(self.base.index))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        bag, hw = self.bag_size, self.img_size
        lane = np.arange(bag)
        for s in range(skip_batches * batch_size, len(order), batch_size):
            sel = order[s:s + batch_size]
            b = len(sel)
            slots = self._item_slot[sel]
            valid = lane[None, :] < self._item_len[sel][:, None]
            pos = self._wsi_base[slots][:, None] + self._item_off[sel][:, None] + lane
            pos = np.minimum(pos, len(self._ids_flat) - 1)
            index = np.full(batch_size * bag + batch_size, self._zero_row, np.int32)
            index[: b * bag] = np.where(valid, self._ids_flat[pos], self._zero_row).ravel()
            index[batch_size * bag:] = self._n_slides
            index[batch_size * bag: batch_size * bag + b] = slots
            index = torch.from_numpy(index).to(self.device)
            rows, slot_index = index[: batch_size * bag], index[batch_size * bag:]
            batch: dict = {
                "patch_bag": self._cache.index_select(0, rows).view(batch_size, bag, hw, hw, 3),
                "bag_mask": (rows != self._zero_row).view(batch_size, bag),
                "sample_mask": slot_index != self._n_slides,
            }
            for k, col in self._dev_scalars.items():
                batch[k] = col.index_select(0, slot_index)
            if self._dev_rna is not None:
                batch["rna_data"] = self._dev_rna.index_select(0, slot_index)
            pad = [""] * (batch_size - b)
            batch["WSI"] = [self._wsi_names[j] for j in slots] + pad
            batch["case"] = [self._case_names[j] for j in slots] + pad
            host_mask = np.zeros((batch_size,), bool)
            host_mask[:b] = True
            batch["host_sample_mask"] = host_mask
            for k, values in self._scalars.items():
                col = np.zeros((batch_size,), values.dtype)
                col[:b] = values[slots]
                batch["host_" + k] = col
            yield batch
