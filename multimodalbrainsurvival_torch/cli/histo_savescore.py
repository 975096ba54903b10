"""Histopathology risk-score export CLI.

Parity with ``1_HistoPathology/3_HistoPath_savescore.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/histo_savescore.py``: loads
``model_path`` (a reference-keyed ``.pt``), evaluates each split, writes
``<output_path>/<model_file>_pathology_<split>[_<flag>]_df.csv``.
"""

from __future__ import annotations

import os

from multimodalbrainsurvival_torch.cli._common import (
    build_datasets,
    load_config,
    make_parser,
    savescore_name,
    serving_adapter,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.train import TrainSettings, evaluate


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    output_path = config.get("output_path", "")
    os.makedirs(output_path or ".", exist_ok=True)

    datasets = build_datasets(config, bool(args.quick))
    adapter = serving_adapter(config, device, datasets)
    settings = TrainSettings(task=config.task, batch_size=config.batch_size)
    prefix = os.path.basename(str(config["model_path"]).rstrip("/")) + "_pathology"
    for split, ds in datasets.items():
        print(f"Evaluation for dataset : {split}")
        # savescore writes the CASE-level frame (3_HistoPath_savescore.py:110-117)
        _, frames, _ = evaluate(adapter, ds, settings, split=split)
        out = os.path.join(output_path, savescore_name(prefix, split, flag))
        write_frame(out, frames["case"])
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
