"""Patch-bag dataset of the histopathology CLIs (train and eval batches).

The port's own copy of ``multimodalbrainsurvival_tpu/data/patches.py:36-370``
(reference ``1_HistoPathology/models.py:234-295`` ``PatchBagDataset``):

- a cohort CSV row per slide with ``wsi_file_name`` (read with the stdlib
  ``csv`` module; a UTF-8 BOM on the header is stripped);
- the slide's patch directory ``<data_path>/<WSI>/`` holds ``loc.txt``,
  whose line count minus its 2 header lines is the patch count, capped at
  ``max_patches_total``;
- patches come from the packed ``patches.npy`` shard when it is at least as
  new as ``loc.txt``, else from ``<WSI>_patch_<i>.png`` (decoded with cv2,
  imported only then, BGR → RGB);
- patches are chunked into bags of ``bag_size``; the remainder is dropped
  unless ``keep_remainder``;
- batches are statically shaped: the last one is padded and masked
  (``sample_mask``), short bags are masked (``bag_mask``);
- training re-permutes each slide's patch list once per epoch
  (``shuffle``, reference ``models.py:269-272``) from a numpy generator
  seeded with ``seed``, and reads the bags in the order
  ``np.random.default_rng(seed).shuffle`` gives (``batches(shuffle=True,
  seed=...)``), the JAX package's order.

Batches are read by a pool of threads in a producer thread that keeps at
most ``prefetch`` batches ahead (``data/patches.py:284-350`` of the JAX
package). Only numpy and the standard library are needed unless a bag must
decode PNGs or resize shard rows. The C++ loader and the device cache of
the JAX package come with a later slice (ROADMAP.md, queue 1, item 11).
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def _resize(img: np.ndarray, img_size: int) -> np.ndarray:
    import cv2

    return cv2.resize(img, (img_size, img_size), interpolation=cv2.INTER_LINEAR)


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
            entry.update({"WSI": wsi, "images": images, "packed_path": packed})
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

    def _load_bag(self, item_idx: int) -> dict:
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
        bag_mask = np.zeros((self.bag_size,), bool)
        bag_mask[: len(items)] = True
        return {"patch_bag": bag, "bag_mask": bag_mask, **_labels(entry)}

    def _assemble(self, items: list[dict], batch_size: int) -> dict:
        batch: dict = {
            "patch_bag": np.zeros(
                (batch_size, self.bag_size, self.img_size, self.img_size, 3),
                np.uint8,
            ),
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
            batch["patch_bag"][i] = it["patch_bag"]
            batch["bag_mask"][i] = it["bag_mask"]
            batch["sample_mask"][i] = True
            batch["WSI"][i] = it["WSI"]
            batch["case"][i] = it["case"]
            for k in scalar_keys:
                batch[k][i] = it[k]
        return batch

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
        unread. A producer thread reads each batch's bags with a pool of
        ``num_threads`` threads and keeps at most ``prefetch`` batches
        ahead; it stops when the consumer closes the generator, and an
        exception it raises is raised to the consumer."""
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
                with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
                    for start in starts:
                        items = list(pool.map(self._load_bag,
                                              order[start:start + batch_size]))
                        if not put(self._assemble(items, batch_size)):
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
