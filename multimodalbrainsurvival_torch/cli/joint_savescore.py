"""Joint fusion risk-score export CLI.

Parity with ``5_JointFusion/2_JointFusion_savescore.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/joint_savescore.py``: loads
``model_path`` (a reference-keyed ``.pt`` of the joint model), evaluates
each split, and writes the case-level frames
``<output_path>/<model_file>_joint_<split>[_<flag>]_df.csv`` (``:96``,
``:219-223``). ``fold_bn: true`` folds BatchNorm and runs a Bottleneck
ResNet's layer1 and layer2 tail through K4; ``quantize: "int8"`` serves
the W8A8 ResNet (K3, calibrated on the first train batch) and the W8A8 RNA
encoder (``quantized_mlp``) under the float head.
"""

from __future__ import annotations

import functools
import os

from multimodalbrainsurvival_torch.cli._common import (
    load_config,
    make_parser,
    savescore_name,
    serving_adapter,
    single_device_serving,
)
from multimodalbrainsurvival_torch.cli.joint_train import (
    build_joint_datasets,
    build_joint_model,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.train import TrainSettings, evaluate
from multimodalbrainsurvival_torch.train.adapters import JointAdapter


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    with single_device_serving(device) as serving:
        if not serving:
            return
        config, flag = load_config(args)
        output_path = config.get("output_path", "")
        os.makedirs(output_path or ".", exist_ok=True)

        datasets = build_joint_datasets(config, bool(args.quick))
        build = functools.partial(build_joint_model, in_features=datasets["train"].rna_dim)
        adapter = serving_adapter(config, device, datasets, build, JointAdapter)
        settings = TrainSettings(task=config.task, num_classes=config.num_classes,
                                 batch_size=config.batch_size)
        prefix = os.path.basename(str(config["model_path"]).rstrip("/")) + "_joint"
        for split, ds in datasets.items():
            print(f"Evaluation for dataset : {split}")
            # savescore writes the CASE-level frame (2_JointFusion_savescore.py:96)
            _, frames, _ = evaluate(adapter, ds, settings, split=split)
            out = os.path.join(output_path, savescore_name(prefix, split, flag))
            write_frame(out, frames["case"])
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
