"""RNA pipeline feature-embedding export CLI.

Parity with ``2_GeneExpression/3_GeneExpress_extractfeatures.py`` and the
JAX CLI ``multimodalbrainsurvival_tpu/cli/rna_extractfeatures.py``: runs the
encoder's 2048-d ``extract`` over every split, takes the per-case mean
(``:73-81``) and writes ``rna_cases_<split>.csv`` (the bytes of
``pd.DataFrame(cases).to_csv``) and ``rna_features_<split>.csv``
(``np.savetxt``, comma-delimited; ``:136-149``) into ``output_path``.
``quantize: "int8"`` extracts through the W8A8 encoder.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from multimodalbrainsurvival_torch.cli._common import (
    extract_features_frames,
    load_config,
    make_parser,
    single_device_serving,
)
from multimodalbrainsurvival_torch.cli.rna_train import build_rna_datasets, rna_serving_adapter
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.train.adapters import TableAdapter


def extract_split(adapter: TableAdapter, dataset, batch_size: int):
    """(cases, (N, D) features) of the real rows of a split, copied back
    from the device once."""
    feats, masks, cases = [], [], []
    for batch in dataset.batches(batch_size, **adapter.loader_kwargs):
        feats.append(adapter.extract(adapter.to_device(batch, adapter.array_keys)))
        mask = np.asarray(batch[adapter.sample_mask_key])
        masks.append(mask)
        cases.extend(c for c, m in zip(batch["case"], mask) if m)
    if not feats:
        return cases, np.zeros((0, adapter.model.rna_mlp.out_features), np.float32)
    return cases, torch.cat(feats).cpu().numpy()[np.concatenate(masks)]


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    with single_device_serving(device) as serving:
        if not serving:
            return
        config, flag = load_config(args)
        output_path = config.get("output_path", "")
        os.makedirs(output_path or ".", exist_ok=True)

        datasets = build_rna_datasets(config)
        adapter = rna_serving_adapter(config, device, datasets["train"].feature_dim)
        suffix = f"_{flag}" if "cv" in flag else ""
        for split, ds in datasets.items():
            print(f"extracting features for dataset : {split}")
            cases, feats = extract_split(adapter, ds, config.batch_size)
            uc, uf = extract_features_frames(cases, feats)
            write_frame(os.path.join(output_path, f"rna_cases_{split}{suffix}.csv"), {"0": uc})
            np.savetxt(os.path.join(output_path, f"rna_features_{split}{suffix}.csv"),
                       uf, delimiter=",")


if __name__ == "__main__":
    main()
