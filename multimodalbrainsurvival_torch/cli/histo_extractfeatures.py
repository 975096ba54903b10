"""Histopathology feature-embedding export CLI.

Parity with ``1_HistoPathology/4_HistoPath_extractfeatures.py`` and the JAX
CLI ``multimodalbrainsurvival_tpu/cli/histo_extractfeatures.py``: runs the
bag embedding (``model.extract``) over every split, takes the per-case mean
and writes ``pathology_cases_<split>.csv`` + ``pathology_features_<split>.csv``
into ``output_path``. The model runs in its ``compute_dtype``.

Under ``mesh: {"dp": D}`` (``python -m torch.distributed.run
--nproc_per_node D -m multimodalbrainsurvival_torch.cli.histo_extractfeatures
--config cfg.json``) each rank embeds its rows of every batch (its
patches, with ``shard_bag``), the embeddings are gathered in rank order,
and rank 0 writes the frames, equal to a world-of-one run's. With
``quantize: "int8"`` rank 0 calibrates and every rank takes its qtree;
with ``fold_bn: true`` each rank packs K4's weights from the same folded
weights.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from multimodalbrainsurvival_torch.cli._common import (
    build_datasets,
    extract_features_frames,
    load_config,
    make_device_put,
    make_parser,
    serving_adapter,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.parallel import mesh as parallel
from multimodalbrainsurvival_torch.parallel.mesh import BatchPut, host_to_global
from multimodalbrainsurvival_torch.train.adapters import MILAdapter


def extract_split(adapter: MILAdapter, dataset, batch_size: int, put: BatchPut | None = None):
    """(cases, (N, D) features) of the real samples of a split. The device
    results stay on the device until the split ends: one copy back, so the
    host reads the next batch while the card works. Under ``put`` each rank
    embeds its part of a batch and the embeddings are gathered."""
    feats, masks, cases = [], [], []
    for batch in dataset.batches(batch_size, **adapter.loader_kwargs):
        with parallel.activate(put):
            arrays = adapter.to_device(host_to_global(batch, put), adapter.array_keys)
            feats.append(parallel.gather_rows(adapter.extract(arrays)))
        mask = np.asarray(batch[adapter.sample_mask_key])
        masks.append(mask)
        cases.extend(c for c, m in zip(batch["case"], mask) if m)
    if not feats:
        return cases, np.zeros((0, adapter.model.resnet.feature_dim), np.float32)
    out = torch.cat(feats).cpu().numpy()
    return cases, out[np.concatenate(masks)]


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    put, device, flag = make_device_put(config, device, flag)
    output_path = config.get("output_path", "")
    os.makedirs(output_path or ".", exist_ok=True)

    datasets = build_datasets(config, bool(args.quick))
    adapter = serving_adapter(config, device, datasets, put=put)
    suffix = f"_{flag}" if "cv" in flag else ""
    for split, ds in datasets.items():
        print(f"extracting features for dataset : {split}")
        cases, feats = extract_split(adapter, ds, config.batch_size, put)
        if put is not None and put.mesh.rank != 0:
            continue
        uc, uf = extract_features_frames(cases, feats)
        write_frame(os.path.join(output_path, f"pathology_cases_{split}{suffix}.csv"),
                    {"0": uc})
        np.savetxt(
            os.path.join(output_path, f"pathology_features_{split}{suffix}.csv"),
            uf, delimiter=",",
        )


if __name__ == "__main__":
    main()
