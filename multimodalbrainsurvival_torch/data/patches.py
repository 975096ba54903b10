"""Patch-bag dataset of the histopathology CLIs (train and eval batches).

The port's own copy of ``multimodalbrainsurvival_tpu/data/patches.py:36-370``
(reference ``1_HistoPathology/models.py:234-295`` ``PatchBagDataset``):

- a cohort CSV row per slide with ``wsi_file_name`` (read with the stdlib
  ``csv`` module; a UTF-8 BOM on the header is stripped);
- the slide's patch directory ``<data_path>/<WSI>/`` holds ``loc.txt``,
  whose line count minus its 2 header lines is the patch count, capped at
  ``max_patches_total``;
- patches come from the packed ``patches.npy`` shard when it is at least as
  new as ``loc.txt``, else from ``<WSI>_patch_<i>.png``;
- patches are chunked into bags of ``bag_size``; the remainder is dropped
  unless ``keep_remainder``;
- batches are statically shaped: the last one is padded and masked
  (``sample_mask``), short bags are masked (``bag_mask``);
- training re-permutes each slide's patch list once per epoch
  (``shuffle``, reference ``models.py:269-272``) from a numpy generator
  seeded with ``seed``, and reads the bags in the order
  ``np.random.default_rng(seed).shuffle`` gives (``batches(shuffle=True,
  seed=...)``), the JAX package's order.

Each batch is assembled in one call of the C++ loader (``data/native.py``,
JAX ``data/patches.py:233-330``): shard rows are copied with ``memcpy`` and
PNGs decoded (RGB) by its thread pool of ``num_threads`` straight into the
batch buffer, with the GIL released, in a producer thread that keeps at
most ``prefetch`` batches ahead. The buffer is one the dataset reuses once
no batch, view or tensor made from it is alive: a fresh 38.5 MB buffer
(16 bags x 16 at 224 px) pays a page fault per 4 KB on every batch, about
two thirds of the read's time (23.8 against 8.2 ms a batch on the host of
an NVIDIA H100 machine; PERF.md). A PNG the loader cannot decode raises,
naming the file; a shard row of another size than ``img_size`` is resized
(bilinear, ``data/opencv_compat.py::resize_linear``, OpenCV's
``INTER_LINEAR`` in numpy). ``_load_batch_plain`` reads the same
batch bag by bag on a thread pool (cv2 for PNGs), the path before the
loader: the tests' plain version and the yardstick ``chip_smoke.py`` times
the loader against; the datasets' ``batches`` never take it.

``PatchBagRNADataset`` and ``PatchRNADataset`` (JAX ``data/patches.py:
371-470``, reference ``5_JointFusion/datasets.py:62-126``) add the slide's
RNA vector, the CSV's ``rna_`` columns of its row, as ``rna_data``; it is
kept with the slide's entry, so it follows the slide through the
shuffles, the producer thread and a resume's skipped batches. The device
cache (``data/device_cache.py``) wraps any of these datasets.
"""

from __future__ import annotations

import csv
import os
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from multimodalbrainsurvival_torch.data import native
from multimodalbrainsurvival_torch.data.opencv_compat import resize_linear

#: batch buffers a dataset keeps for reuse: the one its consumer holds while
#: asking for the next, the ``prefetch`` (2) queued, the one being filled
BATCH_BUFFERS = 4


def _resize(img: np.ndarray, img_size: int) -> np.ndarray:
    return resize_linear(img, (img_size, img_size))


def _read_patch(path: str, img_size: int) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR uint8
    if img is None:
        raise FileNotFoundError(path)
    if img.shape[0] != img_size or img.shape[1] != img_size:
        img = _resize(img, img_size)
    return img[:, :, ::-1]  # RGB


def read_csv_rows(path: str) -> list[dict[str, str]]:
    """Rows of a CSV as dicts of strings, BOM stripped from the header."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [{k.lstrip("﻿"): v for k, v in row.items()} for row in rows]


def _labels(entry: dict) -> dict:
    out = {"WSI": entry["WSI"], "case": str(entry.get("case", entry["WSI"]))}
    for k in ("survival_months", "vital_status"):
        if k in entry:
            out[k] = np.float32(float(entry[k]))
    for k in ("survival_bin", "label", "grade_binary"):
        if k in entry:
            out[k] = np.int32(float(entry[k]))
    return out


class PatchBagDataset:
    """Index of (WSI, bag-offset) chunks over per-slide patch directories."""

    def __init__(
        self,
        patch_data_path: str,
        csv_path: str,
        img_size: int = 224,
        bag_size: int = 40,
        max_patches_total: int = 1000,
        *,
        keep_remainder: bool = False,
        seed: int = 0,
    ):
        self.img_size = img_size
        self.bag_size = bag_size
        self._rng = np.random.default_rng(seed)
        self._buffers: list[np.ndarray] = []
        self._buffers_lock = threading.Lock()
        self.data: dict[str, dict] = {}
        self.index: list[tuple[str, int]] = []

        for row in read_csv_rows(csv_path):
            wsi = str(row["wsi_file_name"]).split(".")[0]
            loc = os.path.join(patch_data_path, wsi, "loc.txt")
            with open(loc) as f:
                n_patches = sum(1 for _ in f) - 2
            n_patches = min(n_patches, max_patches_total)
            packed = os.path.join(patch_data_path, wsi, "patches.npy")
            if os.path.isfile(packed) and os.path.getmtime(
                packed
            ) >= os.path.getmtime(loc):
                images: list = list(range(n_patches))
            else:
                packed = None
                images = [
                    os.path.join(patch_data_path, wsi, f"{wsi}_patch_{i}.png")
                    for i in range(n_patches)
                ]
            entry = {k.lower(): v for k, v in row.items()}
            entry.update({"WSI": wsi, "images": images, "n_images": len(images),
                          "packed_path": packed})
            self.data[wsi] = entry
            n_bags = len(images) // bag_size
            for k in range(n_bags):
                self.index.append((wsi, bag_size * k))
            if keep_remainder and len(images) % bag_size:
                self.index.append((wsi, bag_size * n_bags))

    def shuffle(self) -> None:
        """Per-epoch re-permutation of each slide's patch list (reference
        ``models.py:269-272``)."""
        for entry in self.data.values():
            self._rng.shuffle(entry["images"])

    def __len__(self) -> int:
        return len(self.index)

    def _shard(self, entry: dict) -> np.ndarray:
        shard = entry.get("_mmap")
        if shard is None:
            shard = np.load(entry["packed_path"], mmap_mode="r")
            entry["_mmap"] = shard
        return shard

    def _bag_meta(self, item_idx: int) -> dict:
        """Everything of a bag but its pixels: its mask and its slide's
        labels (subclasses add per-slide arrays here)."""
        wsi, off = self.index[item_idx]
        entry = self.data[wsi]
        bag_mask = np.zeros((self.bag_size,), bool)
        bag_mask[: len(entry["images"][off : off + self.bag_size])] = True
        return {"bag_mask": bag_mask, **_labels(entry)}

    def _load_bag(self, item_idx: int) -> dict:
        """One bag read in Python (cv2 for PNGs): ``_load_batch_plain``'s
        part."""
        wsi, off = self.index[item_idx]
        entry = self.data[wsi]
        items = entry["images"][off : off + self.bag_size]
        bag = np.zeros((self.bag_size, self.img_size, self.img_size, 3), np.uint8)
        if entry["packed_path"]:
            rows = np.asarray(self._shard(entry)[np.asarray(items, np.intp)])
            if rows.shape[1] != self.img_size:
                for j, r in enumerate(rows):
                    bag[j] = _resize(r, self.img_size)
            else:
                bag[: len(items)] = rows
        else:
            for j, p in enumerate(items):
                bag[j] = _read_patch(p, self.img_size)
        return {"patch_bag": bag, **self._bag_meta(item_idx)}

    def _assemble(self, items: list[dict], batch_size: int, *, patch_bag=None) -> dict:
        """One statically shaped batch of the items' metadata, and of their
        pixels unless ``patch_bag`` already holds them."""
        batch: dict = {
            "patch_bag": patch_bag if patch_bag is not None else np.zeros(
                (batch_size, self.bag_size, self.img_size, self.img_size, 3), np.uint8),
            "bag_mask": np.zeros((batch_size, self.bag_size), bool),
            "sample_mask": np.zeros((batch_size,), bool),
            "WSI": [""] * batch_size,
            "case": [""] * batch_size,
        }
        scalar_keys = [
            k for k in items[0] if k not in ("patch_bag", "bag_mask", "WSI", "case")
        ]
        for k in scalar_keys:
            batch[k] = np.zeros((batch_size,), np.asarray(items[0][k]).dtype)
        for i, it in enumerate(items):
            if patch_bag is None:
                batch["patch_bag"][i] = it["patch_bag"]
            batch["bag_mask"][i] = it["bag_mask"]
            batch["sample_mask"][i] = True
            batch["WSI"][i] = it["WSI"]
            batch["case"][i] = it["case"]
            for k in scalar_keys:
                batch[k][i] = it[k]
        return batch

    def _load_batch_plain(self, idx: np.ndarray, batch_size: int,
                          pool: ThreadPoolExecutor) -> dict:
        """The bags of ``idx`` read one by one on ``pool`` and copied into
        the batch: the plain version of ``_load_batch``."""
        return self._assemble(list(pool.map(self._load_bag, idx)), batch_size)

    def _read_slots(self, flat: np.ndarray, runs: list, num_threads: int) -> None:
        """Fill ``flat`` (slots, H, W, 3) in one call of the C++ loader:
        each ``(first_slot, entry, items)`` of ``runs`` puts the slide's
        ``items`` (shard rows or PNG paths) in the slots from
        ``first_slot`` on; other slots stay as they are."""
        n_slots = len(flat)
        paths: list = [None] * n_slots
        srcs = np.zeros(n_slots, np.uintp)
        src_h = np.zeros(n_slots, np.int32)
        src_w = np.zeros(n_slots, np.int32)
        shard_rows: dict[int, tuple] = {}  # slot -> (shard, row), for a resize
        for first, entry, items in runs:
            if entry["packed_path"]:
                shard = self._shard(entry)
                for slot, row in enumerate(items, first):
                    srcs[slot] = shard.ctypes.data + int(row) * shard.strides[0]
                    src_h[slot], src_w[slot] = shard.shape[1], shard.shape[2]
                    shard_rows[slot] = (shard, int(row))
            else:
                paths[first : first + len(items)] = items
        codes = native.assemble_patch_batch(paths, srcs, src_h, src_w, flat,
                                            num_threads=num_threads)
        for slot in np.flatnonzero(codes == native.RESIZE_CODE):
            shard, row = shard_rows[slot]
            flat[slot] = _resize(np.asarray(shard[row]), self.img_size)

    def _batch_buffer(self, shape: tuple) -> np.ndarray:
        """A uint8 batch buffer of ``shape``: one of the dataset's
        ``BATCH_BUFFERS`` that nothing else references any more (no batch,
        view or tensor made from it is alive), else a new one. A fresh
        38.5 MB buffer (16 x 16 x 224 px) costs its page faults on every
        batch: most of the read (the module docstring)."""
        with self._buffers_lock:
            for buf in self._buffers:
                # referenced by the list, this loop and getrefcount alone
                if buf.shape == shape and sys.getrefcount(buf) == 3:
                    return buf
            buf = np.empty(shape, np.uint8)
            if len(self._buffers) < BATCH_BUFFERS:
                self._buffers.append(buf)
            return buf

    def _load_batch(self, idx: np.ndarray, batch_size: int, num_threads: int) -> dict:
        """The bags of ``idx`` in one call of the C++ loader, straight into
        a batch buffer, the slots no patch fills zeroed: byte for byte
        ``_load_batch_plain``'s batch."""
        bag, hw = self.bag_size, self.img_size
        buf = self._batch_buffer((batch_size, bag, hw, hw, 3))
        flat = buf.reshape(-1, hw, hw, 3)
        runs = []
        for i, item_idx in enumerate(idx):
            wsi, off = self.index[item_idx]
            entry = self.data[wsi]
            items = entry["images"][off : off + bag]
            runs.append((i * bag, entry, items))
            flat[i * bag + len(items) : (i + 1) * bag] = 0
        flat[len(idx) * bag :] = 0
        self._read_slots(flat, runs, num_threads)
        return self._assemble([self._bag_meta(k) for k in idx], batch_size, patch_bag=buf)

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int | None = None,
        num_threads: int = 8,
        prefetch: int = 2,
        skip_batches: int = 0,
    ) -> Iterator[dict]:
        """Statically shaped uint8 bag batches, in index order or, with
        ``shuffle``, in the order ``np.random.default_rng(seed)`` gives;
        the first ``skip_batches`` batches of that order are dropped
        unread. A producer thread assembles each batch in one call of the
        C++ loader on ``num_threads`` threads and keeps at most
        ``prefetch`` batches ahead; it stops when the consumer closes the
        generator, and an exception it raises is raised to the consumer."""
        order = np.arange(len(self.index))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        starts = range(skip_batches * batch_size, len(order), batch_size)
        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer is gone, so an
            # abandoned generator does not keep the thread and its batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for start in starts:
                    batch = self._load_batch(order[start:start + batch_size], batch_size,
                                             max(1, num_threads))
                    if not put(batch):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001 - raised to the consumer
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # free a producer blocked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)


def read_rna_columns(path: str) -> tuple[list[str], np.ndarray]:
    """Each row's ``wsi_file_name`` without its extension, and the (rows,
    genes) float32 matrix of the columns whose name contains ``rna_``, read
    with the stdlib ``csv`` module (BOM stripped)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = [c.lstrip("\ufeff") for c in next(reader)]
        rna_idx = [i for i, c in enumerate(columns) if "rna_" in c]
        if not rna_idx:
            raise ValueError(f"No 'rna_' columns in {path}")
        wsi_col = columns.index("wsi_file_name")
        wsis, rows = [], []
        for row in reader:
            wsis.append(str(row[wsi_col]).split(".")[0])
            rows.append(np.asarray([row[i] for i in rna_idx], np.float64))
    return wsis, np.asarray(rows, np.float64).astype(np.float32).reshape(-1, len(rna_idx))


class PatchBagRNADataset(PatchBagDataset):
    """Bag index + the case's RNA vector (``5_JointFusion/datasets.py:
    62-126``): batches add ``rna_data`` (B, genes) float32, zero on padded
    rows."""

    def __init__(self, patch_data_path: str, csv_path: str, **kw):
        super().__init__(patch_data_path, csv_path, **kw)
        wsis, rna = read_rna_columns(csv_path)
        for wsi, vector in zip(wsis, rna):
            self.data[wsi]["rna_data"] = vector
        self.rna_dim = rna.shape[1]

    def _bag_meta(self, item_idx: int) -> dict:
        out = super()._bag_meta(item_idx)
        out["rna_data"] = self.data[self.index[item_idx][0]]["rna_data"]
        return out

    def _assemble(self, items: list[dict], batch_size: int, *, patch_bag=None) -> dict:
        rna = np.zeros((batch_size, self.rna_dim), np.float32)
        for i, it in enumerate(items):
            rna[i] = it.pop("rna_data")
        batch = super()._assemble(items, batch_size, patch_bag=patch_bag)
        batch["rna_data"] = rna
        return batch


class PatchRNADataset(PatchBagRNADataset):
    """One item per patch + the case's RNA vector, for the per-patch joint
    model (the reference's version is broken, ``5_JointFusion/datasets.py:
    182``): a ``bag_size=1`` index with the remainder kept; batches also
    give ``patch`` (B, H, W, 3)."""

    def __init__(self, patch_data_path: str, csv_path: str, **kw):
        kw.pop("bag_size", None)
        kw.pop("keep_remainder", None)
        super().__init__(patch_data_path, csv_path, bag_size=1, keep_remainder=True,
                         **kw)

    def _assemble(self, items: list[dict], batch_size: int, *, patch_bag=None) -> dict:
        batch = super()._assemble(items, batch_size, patch_bag=patch_bag)
        batch["patch"] = batch["patch_bag"][:, 0]
        return batch
