"""Streaming bimodal (whole slide + RNA) scoring CLI.

Parity with the JAX CLI ``multimodalbrainsurvival_tpu/cli/slide_joint_savescore.py``:
scores a joint-fusion cohort straight from its slide files, with no patch
directories. Per row of ``slide_csv_path`` (the ``joint_example.csv``
schema: ``case``, ``wsi_file_name``, the ``rna_*`` columns, optionally
``survival_months`` / ``vital_status``), the slide's tissue tiles stream
through the per-patch ResNet (``cli/slide_extractfeatures.py``: float,
``fold_bn: true`` through K4, or ``quantize: "int8"`` through K3), then one
slide-spanning bag and the row's RNA vector go through the joint model's
tail (``BagHistopathologyRNAModel.from_feats``: the bag mean beside the
RNA encoder's embedding, then the head). The RNA encoder stays float, as
in the JAX CLI.

Output: ``<output_path>/joint_slide_scores<suffix>.csv`` (slide, case,
n_patches, score, and the survival columns when the CSV has them); with
survival labels the case-level C-index is printed.

Under ``mesh: {"dp": D}`` the tiles stream as in ``slide_extractfeatures``
(each rank encodes its rows of every batch, the int8 encoder calibrated on
rank 0; JAX ``:121-142``) and rank 0 alone runs the joint tail and writes
the frame.

    python -m multimodalbrainsurvival_torch.cli.slide_joint_savescore \\
        --config cfg.json [--device cpu]
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from multimodalbrainsurvival_torch.cli._common import (
    load_config,
    make_device_put,
    make_parser,
)
from multimodalbrainsurvival_torch.cli.joint_train import build_joint_model
from multimodalbrainsurvival_torch.cli.slide_extractfeatures import (
    check_mesh_batch,
    frame_of_rows,
    pad_slide_bag,
    resolve_slides,
    score_columns,
    serving_encoder,
    stream_slide_features,
    tile_config,
)
from multimodalbrainsurvival_torch.data.tiler import open_slide
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import n_rows, read_frame, write_frame
from multimodalbrainsurvival_torch.ops.metrics import survival_ci


def make_joint_tail(model: torch.nn.Module):
    """``((N, D) features, (G,) RNA vector) → (C,) float32 scores`` over one
    padded slide bag."""

    @torch.inference_mode()
    def tail(feats: torch.Tensor, rna: torch.Tensor) -> torch.Tensor:
        bag, mask = pad_slide_bag(feats)
        return model.from_feats(bag, rna[None].float(), mask)[0].float()

    return tail


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    put, device, flag = make_device_put(config, device, flag)
    check_mesh_batch(put, config.batch_size)
    output_path = config.get("output_path", "")
    os.makedirs(output_path or ".", exist_ok=True)

    table = read_frame(config["slide_csv_path"])
    limit = 2 if args.quick else None
    rna_cols = [c for c in table if str(c).startswith("rna_")]
    if not rna_cols:
        raise ValueError(f"{config['slide_csv_path']}: no rna_* columns")
    rna_all = np.array([table[c][:limit] for c in rna_cols], np.float64).T.astype(np.float32)
    slides = resolve_slides(config, limit=limit)

    cfg = tile_config(config)
    build = functools.partial(build_joint_model, in_features=len(rna_cols))
    model, patch_extract, masks = serving_encoder(config, device, slides, cfg, build, put)
    joint_tail = make_joint_tail(model)

    rows = []
    for i, ((path, sid, case), rna) in enumerate(zip(slides, rna_all)):
        feats, _ = stream_slide_features(patch_extract, open_slide(path), cfg,
                                         config.batch_size, device, mask=masks.get(path),
                                         put=put)
        if put is not None and put.mesh.rank != 0:
            continue
        if feats.shape[0] == 0:
            print(f"{sid}: no tissue tiles — skipped")
            continue
        scores = joint_tail(feats, torch.as_tensor(rna, device=device)).cpu().numpy()
        row = {"slide": sid, "case": case, "n_patches": feats.shape[0], **score_columns(scores)}
        for label in ("survival_months", "vital_status"):
            if label in table:
                row[label] = table[label][i]
        rows.append(row)
        print(f"{sid}: {feats.shape[0]} patches, score {row.get('score', scores.tolist())}")

    if put is not None and put.mesh.rank != 0:
        return
    if not rows:
        raise SystemExit("no slide produced any tissue tiles")
    frame = frame_of_rows(rows)
    suffix = f"_{flag}" if "cv" in flag else ""
    write_frame(os.path.join(output_path, f"joint_slide_scores{suffix}.csv"), frame,
                index=False)
    if {"survival_months", "vital_status", "score"} <= set(frame) and n_rows(frame):
        ci, _ = survival_ci(np.asarray(frame["score"]), list(frame["case"]),
                            np.asarray(frame["survival_months"]),
                            np.asarray(frame["vital_status"]))
        print(f"case-level CI: {ci:.4f}")


if __name__ == "__main__":
    main()
