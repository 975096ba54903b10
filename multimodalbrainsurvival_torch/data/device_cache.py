"""Device-resident patch cache: the cohort decoded once, held on the card.

The port's own copy of
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
package's messages.

Under a mesh (``put``, a ``parallel.BatchPut`` of more than one rank; JAX
``:126-505``) the cache rows are block-sharded over the ``dp x mp`` ranks
in rank order, rank ``r`` holding rows ``[r L, (r + 1) L)`` with ``L =
ceil(N / world)``, so the budget is ``world x cache_max_bytes_per_device``
and is counted per rank (ranks that share one card each hold their own
block there). Each batch, every rank computes the global batch's cache
rows (the same numpy on every rank), gathers the rows it owns that each
rank needs, and one ``all_to_all`` hands each rank its own ``dp`` rows (its
``bag / mp`` patches under ``shard_bag``, which needs ``bag_size % mp ==
0``): the pixels move once, never summed (gloo has no uint8 reduction),
and a rank receives only its part. The batch's ``patch_bag`` is that part
(``placed_keys`` names it, so ``BatchPut`` leaves it as it is); the masks,
labels, ``WSI`` / ``case`` lists and ``host_*`` mirrors are the global
batch's, as the host loader's are, and ``BatchPut`` slices the device ones.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from multimodalbrainsurvival_torch.data.patches import _labels
from multimodalbrainsurvival_torch.parallel import mesh as parallel

DEFAULT_MAX_BYTES = 12 << 30


def cache_bytes(base) -> int:
    n = sum(e["n_images"] for e in base.data.values())
    return n * base.img_size * base.img_size * 3


def _n_shards(put) -> int:
    return 1 if put is None else put.mesh.world


def cache_fits(base, max_bytes: int, put=None) -> bool:
    return cache_bytes(base) <= max_bytes * _n_shards(put)


def maybe_cache_on_device(base, enabled: bool, *, device: torch.device,
                          max_bytes: int = DEFAULT_MAX_BYTES, num_threads: int = 8,
                          put=None):
    """``base`` held on ``device`` (block-sharded over ``put``'s mesh) when
    ``enabled`` and it fits in ``max_bytes`` a rank, else ``base`` itself."""
    if not enabled:
        return base
    if not cache_fits(base, max_bytes, put):
        total = sum(e["n_images"] for e in base.data.values())
        print(f"cache_patches_on_device: cohort too large for HBM cache "
              f"({total} patches x {base.img_size}^2x3 > {_n_shards(put)} device(s) x "
              f"{max_bytes} bytes); falling back to the host loader")
        return base
    return DeviceCachedPatchBags(base, device, num_threads=num_threads, put=put)


def maybe_cache_datasets(datasets: dict, enabled: bool, *, device: torch.device,
                         max_bytes: int = DEFAULT_MAX_BYTES, num_threads: int = 8,
                         put=None) -> dict:
    """A ``{split: dataset}`` dict under one shared budget of ``max_bytes``
    a rank (``world x max_bytes`` under ``put``'s mesh): every split held
    on ``device`` if all fit, else only ``train`` if it fits, else none."""
    if not enabled:
        return datasets

    def wrap(ds):
        return DeviceCachedPatchBags(ds, device, num_threads=num_threads, put=put)

    budget = max_bytes * _n_shards(put)
    total = sum(cache_bytes(ds) for ds in datasets.values())
    if total <= budget:
        return {k: wrap(v) for k, v in datasets.items()}
    train = datasets.get("train")
    if train is not None and cache_fits(train, max_bytes, put):
        print("cache_patches_on_device: all splits together exceed the HBM budget "
              f"({total} > {budget} bytes); caching only 'train'")
        return {k: wrap(v) if k == "train" else v for k, v in datasets.items()}
    print(f"cache_patches_on_device: cohort too large for HBM cache ({total} > "
          f"{budget} bytes); falling back to the host loader")
    return datasets


class DeviceCachedPatchBags:
    """A patch-bag dataset whose pixels live on ``device``, block-sharded
    over the ranks of ``put``'s mesh when it has one."""

    def __init__(self, base, device: torch.device, *, num_threads: int = 8, put=None):
        self.base = base
        self.bag_size = base.bag_size
        self.img_size = base.img_size
        self.device = torch.device(device)
        self.put = put
        if put is not None and put.shard_bag and base.bag_size % put.mesh.mp:
            raise ValueError(
                f"shard_bag cache needs bag_size ({base.bag_size}) divisible "
                f"by the mesh's mp axis ({put.mesh.mp})")
        hw = base.img_size
        wsi_keys = list(base.data)
        counts = [base.data[w]["n_images"] for w in wsi_keys]
        n_total = sum(counts)
        starts = np.cumsum([0] + counts[:-1]).astype(np.int64)
        # this rank's block of rows: [lo, hi) (every row without a mesh)
        shards = _n_shards(put)
        self._rows_local = -(-max(n_total, 1) // shards)
        lo = 0 if put is None else put.mesh.rank * self._rows_local
        hi = min(n_total, lo + self._rows_local)
        self._lo = lo

        t0 = time.perf_counter()
        flat = np.zeros((max(hi - lo, 0), hw, hw, 3), np.uint8)
        runs = []
        for s, w in zip(starts, wsi_keys):
            a, b = max(int(s), lo), min(int(s) + base.data[w]["n_images"], hi)
            if a < b:
                runs.append((a - lo, base.data[w], base.data[w]["images"][a - s:b - s]))
        base._read_slots(flat, runs, max(1, num_threads))
        t1 = time.perf_counter()
        # the single-device cache's last row is zero: padding gathers it
        extra = 1 if put is None else 0
        self._zero_row = len(flat)
        self._cache = torch.empty((len(flat) + extra, hw, hw, 3), dtype=torch.uint8,
                                  device=self.device)
        self._cache[:len(flat)].copy_(torch.from_numpy(flat))
        self._cache[len(flat):].zero_()
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
        where = "" if put is None else f" (rows {lo}-{hi} of {n_total}, rank {put.mesh.rank})"
        print(f"cache_patches_on_device: {n_total} patches, {self.nbytes} bytes on "
              f"{self.device}{where} (read {self.read_seconds:.2f} s, upload "
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

    def _exchange(self, rows: np.ndarray) -> torch.Tensor:
        """(B, bag) global cache rows of a batch (-1: padding) → this rank's
        (B / dp, bag or bag / mp, H, W, 3) uint8 part, its padding zero:
        each rank sends each rank the rows it owns of that rank's part, in
        that part's order, in one ``all_to_all``."""
        mesh, hw = self.put.mesh, self.img_size
        B, bag = rows.shape
        if B % mesh.dp:
            raise ValueError(f"mesh-sharded cache needs batch_size ({B}) divisible by "
                             f"the mesh's dp axis ({mesh.dp})")
        b, g = B // mesh.dp, (bag // mesh.mp if self.put.shard_bag else bag)

        def part(r: int) -> np.ndarray:
            block = rows[(r // mesh.mp) * b:(r // mesh.mp + 1) * b]
            if self.put.shard_bag:
                block = block[:, (r % mesh.mp) * g:(r % mesh.mp + 1) * g]
            return block.ravel()

        def owners(need: np.ndarray) -> np.ndarray:
            return np.where(need >= 0, need // self._rows_local, -1)

        send, send_counts = [], []
        for r in range(mesh.world):
            need = part(r)
            mine = need[owners(need) == mesh.rank] - self._lo
            send.append(mine)
            send_counts.append(len(mine))
        need_owner = owners(part(mesh.rank))
        recv_counts = [int((need_owner == r).sum()) for r in range(mesh.world)]
        # where each received row goes: by source rank, in this part's order
        place = np.concatenate([np.flatnonzero(need_owner == r) for r in range(mesh.world)])
        index = torch.from_numpy(np.concatenate(send + [place])).to(self.device)
        rows_out = parallel.all_to_all(self._cache.index_select(0, index[:sum(send_counts)]),
                                       mesh.world_group, recv_counts, send_counts)
        out = torch.zeros((b * g, hw, hw, 3), dtype=torch.uint8, device=self.device)
        out.index_copy_(0, index[sum(send_counts):], rows_out)
        return out.view(b, g, hw, hw, 3)

    def batches(self, batch_size: int, *, shuffle: bool = False, seed: int | None = None,
                skip_batches: int = 0, **_: object) -> Iterator[dict]:
        """The host loader's batches (its order, its ``skip_batches``), with
        every array on the device (under a mesh the rank's part of the
        pixels); the host loader's ``num_threads`` and ``prefetch`` mean
        nothing here."""
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
            rows = np.full((batch_size, bag), -1, np.int64)
            rows[:b] = np.where(valid, self._ids_flat[pos], -1)
            slot_index = np.full(batch_size, self._n_slides, np.int64)
            slot_index[:b] = slots
            index = torch.from_numpy(np.concatenate([rows.ravel(), slot_index])).to(
                self.device)
            flat_rows, slot_index = index[: batch_size * bag], index[batch_size * bag:]
            batch: dict = {
                "bag_mask": (flat_rows >= 0).view(batch_size, bag),
                "sample_mask": slot_index != self._n_slides,
            }
            if self.put is None:
                batch["patch_bag"] = self._cache.index_select(
                    0, torch.where(flat_rows < 0, self._zero_row, flat_rows)).view(
                    batch_size, bag, hw, hw, 3)
            else:
                batch["patch_bag"] = self._exchange(rows)
                batch["placed_keys"] = ("patch_bag",)
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
