"""RNA pipeline risk-score export CLI.

Parity with ``2_GeneExpression/2_GeneExpress_savescore.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/rna_savescore.py``: loads ``model_path``
(a reference-keyed ``.pt``), evaluates each split, and writes the per-case
score frames ``<output_path>/rna_<split>[_<flag>]_df.csv`` (``:180-190``).
``quantize: "int8"`` serves the W8A8 encoder (``models/quantize.py::
quantized_mlp``) under the float Cox head.
"""

from __future__ import annotations

import os

from multimodalbrainsurvival_torch.cli._common import (
    load_config,
    make_parser,
    savescore_name,
    single_device_serving,
)
from multimodalbrainsurvival_torch.cli.rna_train import build_rna_datasets, rna_serving_adapter
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.train import TrainSettings, evaluate


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
        settings = TrainSettings(task="survival_prediction", batch_size=config.batch_size)
        for split, ds in datasets.items():
            print(f"Evaluation for dataset : {split}")
            _, frames, _ = evaluate(adapter, ds, settings, split=split)
            out = os.path.join(output_path, savescore_name("rna", split, flag))
            write_frame(out, frames["case"])
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
