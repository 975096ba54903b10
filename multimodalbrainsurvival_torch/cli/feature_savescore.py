"""Early-fusion risk-score export CLI.

Parity with ``3_EarlyFusion/3_EarlyFusion_savescore.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/feature_savescore.py``: loads
``model_path`` (a reference-keyed ``.pt`` of the early-fusion MLP),
evaluates each split, and writes the per-case score frames
``<output_path>/<model_file>_feature_<split>[_<flag>]_df.csv``
(``:137-185``).
"""

from __future__ import annotations

import os

from multimodalbrainsurvival_torch.cli._common import (
    load_config,
    make_parser,
    savescore_name,
    single_device_serving,
)
from multimodalbrainsurvival_torch.cli.feature_train import (
    build_feature_datasets,
    build_feature_model,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.models.convert import load_reference_state_dict
from multimodalbrainsurvival_torch.train import TrainSettings, evaluate
from multimodalbrainsurvival_torch.train.adapters import TableAdapter


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    with single_device_serving(device) as serving:
        if not serving:
            return
        config, flag = load_config(args)
        output_path = config.get("output_path", "")
        os.makedirs(output_path or ".", exist_ok=True)

        datasets = build_feature_datasets(config)
        model = build_feature_model(in_features=datasets["train"].feature_dim)
        model.load_state_dict(load_reference_state_dict(config["model_path"]))
        adapter = TableAdapter(model=model.to(device).eval(), device=device)
        settings = TrainSettings(task="survival_prediction", batch_size=config.batch_size)
        prefix = os.path.basename(str(config["model_path"]).rstrip("/")) + "_feature"
        for split, ds in datasets.items():
            print(f"Evaluation for dataset : {split}")
            _, frames, _ = evaluate(adapter, ds, settings, split=split)
            out = os.path.join(output_path, savescore_name(prefix, split, flag))
            write_frame(out, frames["case"])
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
