"""Streaming whole-slide → features and scores CLI.

Parity with the JAX CLI ``multimodalbrainsurvival_tpu/cli/slide_extractfeatures.py``:
one command in place of the reference's two stages (``1_WSI2Patches.py``
tiling to disk, then ``4_HistoPath_extractfeatures.py`` over the patch
directories). Tissue tiles stream from the slide file (lazy native TIFF
reads, or a PNG) in the tiler's exact selection and order
(``data/tiler.py::iter_tissue_patches``) into the patch encoder on the
card, and no patch is written to disk. Per slide:

- per-patch ResNet embeddings, ``batch_size`` tiles a launch, in the
  model's ``compute_dtype``: the float encoder, the folded one
  (``fold_bn: true``: layer1 and layer2's tail through K4) or the int8 one
  (``quantize: "int8"``: every conv through K3, calibrated on the first
  slide's real tiles);
- one slide-spanning bag of those embeddings, padded to a multiple of 128
  with a mask, through the aggregator and the head (the attention
  aggregator's pool is K1, one launch a slide);
- the slide's score.

The host tiles batch k+1 while the card encodes batch k: two pinned host
buffers, each copied with ``non_blocking`` and refilled only after the
CUDA event recorded behind its copy. The embeddings stay on the card until
the slide's tail has run; the last batch's padded rows are sliced off.

Under ``mesh: {"dp": D}`` (``python -m torch.distributed.run
--nproc_per_node D -m ...``; JAX ``:209-245``) ``batch_size`` must divide
by ``D`` (``check_mesh_batch``, at start-up). Every rank tiles each slide
itself (the tiler is deterministic) and keeps its ``batch_size / D`` rows
of each batch in its buffers; the slide's features are gathered once, at
its end, in the tiler's order. The int8 encoder is calibrated on rank 0,
every rank taking its qtree. Rank 0 alone runs the slide's tail and
writes the frames, equal to a world-of-one run's.

Outputs under ``output_path``: ``slide_scores<suffix>.csv`` (slide, case,
n_patches, score columns); ``pathology_cases_slides<suffix>.csv`` and
``pathology_features_slides<suffix>.csv`` (per-case mean embeddings, the
``histo_extractfeatures`` format); with ``save_patch_features: true``,
``patch_features/<slide>_features.npy`` (N, D) and
``patch_features/<slide>_patches.csv`` (id, x, y, attention).

Slides come from ``slide_csv_path`` (a CSV with ``wsi_file_name`` and
optionally ``case``; relative names resolve under ``slide_path``) or a
``slides`` list. Tiling keys: ``img_size``, ``max_patches_per_slide``,
``dezoom_factor``, ``background_threshold``.

    python -m multimodalbrainsurvival_torch.cli.slide_extractfeatures \\
        --config cfg.json [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from multimodalbrainsurvival_torch.cli._common import (
    build_mil_model,
    extract_features_frames,
    load_config,
    load_mil_model,
    make_device_put,
    make_parser,
    quantize_mode,
    rank_zero_tree,
)
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data.patches import read_csv_rows
from multimodalbrainsurvival_torch.data.tiler import (
    SLIDE_EXTS,
    TileConfig,
    compute_tissue_mask,
    iter_tissue_patches,
    open_slide,
    slide_id_for,
)
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import write_frame
from multimodalbrainsurvival_torch.models.quantize import (
    quantize_mil_resnet,
    quantized_extract,
)
from multimodalbrainsurvival_torch.ops.image import preprocess_patches
from multimodalbrainsurvival_torch.parallel import mesh as parallel
from multimodalbrainsurvival_torch.parallel.mesh import BatchPut

#: a slide's bag is padded to a multiple of this many patches
BAG_BUCKET = 128


def resolve_slide_path(root: str, name: str) -> str:
    """The slide file for a CSV's ``wsi_file_name``: the name as it is,
    then with each slide extension added, then its stem with each."""
    base = name if os.path.isabs(name) else os.path.join(root, name)
    if os.path.isfile(base):
        return base
    stem = os.path.splitext(base)[0]
    for cand in [base + e for e in SLIDE_EXTS] + [stem + e for e in SLIDE_EXTS]:
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"no slide file for {name!r} under {root!r}")


def resolve_slides(config: Config, limit: int | None = None) -> list[tuple[str, str, str]]:
    """(path, slide_id, case) of each slide of ``slide_csv_path`` or
    ``slides``; ``limit`` cuts the list before any file is looked for."""
    root = config.get("slide_path", "")
    if config.get("slide_csv_path"):
        rows = read_csv_rows(config["slide_csv_path"])
        if rows and "wsi_file_name" not in rows[0]:
            raise ValueError(f"{config['slide_csv_path']}: need a wsi_file_name column")
        entries = [(r["wsi_file_name"], r.get("case")) for r in rows]
    elif config.get("slides"):
        entries = [(name, None) for name in config["slides"]]
    else:
        raise ValueError("config needs slide_csv_path or slides")
    out = []
    for name, case in entries[:limit]:
        sid = slide_id_for(name)
        out.append((resolve_slide_path(root, name), sid, sid if case is None else case))
    return out


def tile_config(config: Config) -> TileConfig:
    return TileConfig(
        patch_size=config.img_size,
        max_patches_per_slide=int(config.get("max_patches_per_slide", 2000)),
        dezoom_factor=float(config.get("dezoom_factor", 1.0)),
        background_threshold=float(config.get("background_threshold", 0.2)),
    )


def make_patch_extract(model: torch.nn.Module, qtree: dict | None = None,
                       arch: str = "resnet50"):
    """``(B, P, P, 3) uint8 tensor → (B, D) float32`` per-patch embeddings
    on the tensor's device: eval preprocessing, then the encoder alone (the
    aggregator runs once a slide, in ``make_slide_tail``). With ``qtree``
    the int8 encoder (float32 preprocessing, as calibrated); else the
    model's ResNet in its dtype (a folded Bottleneck one through K4)."""
    resnet = model.resnet

    @torch.inference_mode()
    def extract(x_u8: torch.Tensor) -> torch.Tensor:
        if qtree is not None:
            x = preprocess_patches(x_u8, dtype=torch.float32)
            return quantized_extract(qtree, x, arch=arch)
        x = preprocess_patches(x_u8, dtype=resnet.dtype)
        return model.patch_features(x[:, None])[:, 0]

    return extract


def pad_slide_bag(feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) per-patch features → one bag padded to a multiple of
    ``BAG_BUCKET``: ((1, Nb, D) float32, (1, Nb) bool mask)."""
    n, d = feats.shape
    nb = -(-n // BAG_BUCKET) * BAG_BUCKET
    bag = torch.zeros((1, nb, d), dtype=torch.float32, device=feats.device)
    bag[0, :n] = feats
    mask = torch.zeros((1, nb), dtype=torch.bool, device=feats.device)
    mask[0, :n] = True
    return bag, mask


def make_slide_tail(model: torch.nn.Module):
    """``(N, D) features → (embedding (D,), scores (C,), attention (N,))``,
    float32 on the features' device: the aggregator (in the model's compute
    dtype; the attention pool through K1) over one padded slide bag, then
    the head."""

    @torch.inference_mode()
    def tail(feats: torch.Tensor):
        n = feats.shape[0]
        bag, mask = pad_slide_bag(feats)
        emb, attention = model.extract_from_feats(bag, mask)
        scores = model.fc(emb.float())
        return emb[0].float(), scores[0].float(), attention[0, :n].float()

    return tail


def check_mesh_batch(put: BatchPut | None, batch_size: int) -> None:
    """At start-up: the tile batches split over the mesh's ``dp`` ranks
    (JAX ``check_mesh_batch``, the same error)."""
    if put is not None and batch_size % put.mesh.dp:
        raise ValueError(
            f"streaming serve under mesh: batch_size {batch_size} must be "
            f"divisible by dp={put.mesh.dp} (batches shard over the batch axis)")


def stream_slide_features(patch_extract, slide, cfg: TileConfig, batch_size: int,
                          device: torch.device, mask: np.ndarray | None = None,
                          timing: dict | None = None,
                          put: BatchPut | None = None) -> tuple[torch.Tensor, list]:
    """One slide's tissue tiles through ``patch_extract``, batch k+1 tiled
    on the host while the card encodes batch k. Returns ``((N, D) float32
    features on device, [(x, y)] level-0 tile positions)``, in the tiler's
    order. Under ``put`` this rank encodes its ``dp`` rows of each batch
    and the features are gathered from every rank at the slide's end.
    ``timing``, when given, gathers ``tile_s`` (host seconds in the tiler
    and the buffer fill), ``wait_s`` (host seconds waiting for a buffer's
    copy) and, on the card, ``encode_ms`` (device time of the encoder
    launches, CUDA events) and ``batches``."""
    cuda = device.type == "cuda"
    P = cfg.patch_size
    rows = batch_size if put is None else batch_size // put.mesh.dp
    lo = 0 if put is None else put.mesh.dp_rank * rows
    bufs = [torch.empty((rows, P, P, 3), dtype=torch.uint8, pin_memory=cuda)
            for _ in range(2)]
    views = [b.numpy() for b in bufs]
    copied: list = [None, None]  # the event behind each buffer's last copy
    spans: list = []
    outs: list[torch.Tensor] = []
    locs: list[tuple[int, int]] = []
    which, count = 0, 0
    tile_s = wait_s = 0.0

    def flush():
        nonlocal which, count
        x = bufs[which].to(device, non_blocking=True)
        if cuda:
            copied[which] = torch.cuda.Event()
            copied[which].record()
        if timing is not None and cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = patch_extract(x)
            end.record()
            spans.append((start, end))
        else:
            out = patch_extract(x)
        outs.append(out)
        which, count = 1 - which, 0

    t = time.perf_counter()
    for _, x, y, patch in iter_tissue_patches(slide, cfg, mask=mask):
        if count == 0 and copied[which] is not None:
            t_wait = time.perf_counter()
            copied[which].synchronize()  # its last copy must have left
            wait_s += time.perf_counter() - t_wait
        if lo <= count < lo + rows:
            views[which][count - lo] = patch
        locs.append((int(x), int(y)))
        count += 1
        if count == batch_size:
            tile_s += time.perf_counter() - t
            flush()
            t = time.perf_counter()
    tile_s += time.perf_counter() - t
    if count:
        flush()  # the last, partial batch
    if timing is not None:
        timing["tile_s"] = timing.get("tile_s", 0.0) + tile_s
        timing["wait_s"] = timing.get("wait_s", 0.0) + wait_s
        timing["batches"] = timing.get("batches", 0) + len(outs)
        if spans:
            spans[-1][1].synchronize()
            timing["encode_ms"] = timing.get("encode_ms", 0.0) + sum(
                s.elapsed_time(e) for s, e in spans)
    if not outs:
        return torch.zeros((0, 0), dtype=torch.float32, device=device), locs
    feats = torch.stack(outs)  # (batches, rows, D)
    if put is not None:
        # (dp, batches, rows, D) in rank order -> each batch's rows in order
        feats = parallel.all_gather(feats[None], put.mesh.dp_group).transpose(0, 1)
    # only the last batch is partial: its padded rows are the last ones
    return feats.reshape(-1, feats.shape[-1])[:len(locs)], locs


def calibrate_int8(model: torch.nn.Module, slides: list, cfg: TileConfig, batch_size: int,
                   arch: str) -> tuple[dict, np.ndarray]:
    """The int8 encoder's qtree, calibrated on up to ``min(batch_size,
    64)`` real tiles of the first slide; and that slide's tissue mask, so
    that its scoring pass does not compute it again."""
    slide = open_slide(slides[0][0])
    mask = compute_tissue_mask(slide, cfg)
    calib = []
    for _, _, _, patch in iter_tissue_patches(slide, cfg, mask=mask):
        calib.append(patch)
        if len(calib) >= min(batch_size, 64):
            break
    if not calib:
        raise ValueError(f"no tissue tiles in {slides[0][0]} to calibrate on")
    qtree = quantize_mil_resnet(model.resnet, [np.stack(calib)], arch=arch)
    print(f"int8: calibrated on {len(calib)} tiles of {slides[0][1]}")
    return qtree, mask


def serving_encoder(config: Config, device: torch.device, slides: list, cfg: TileConfig,
                    build=None, put: BatchPut | None = None
                    ) -> tuple[torch.nn.Module, object, dict]:
    """The model (``build``'s, the MIL model by default) from
    ``model_path`` on ``device``, its per-patch encoder and the masks
    already computed (the int8 calibration slide's, on the rank that
    calibrated: rank 0 of ``put``'s mesh)."""
    model = load_mil_model(config, device, build or build_mil_model)
    qtree, masks = None, {}
    if quantize_mode(config):
        def calibrate():
            tree, masks[slides[0][0]] = calibrate_int8(model, slides, cfg, config.batch_size,
                                                       config.model_name)
            return tree

        qtree = rank_zero_tree(put, calibrate, device)
    return model, make_patch_extract(model, qtree, config.model_name), masks


def score_columns(scores: np.ndarray) -> dict:
    """``score`` for a single output, else ``score_<k>``."""
    if scores.shape[-1] == 1:
        return {"score": float(scores[0])}
    return {f"score_{k}": float(s) for k, s in enumerate(scores)}


def frame_of_rows(rows: list[dict]) -> dict:
    """Rows of dicts → a frame, columns in order of first appearance."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    return {c: [row.get(c, float("nan")) for row in rows] for c in columns}


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    config, flag = load_config(args)
    put, device, flag = make_device_put(config, device, flag)
    check_mesh_batch(put, config.batch_size)
    writes = put is None or put.mesh.rank == 0
    output_path = config.get("output_path", "")
    os.makedirs(output_path or ".", exist_ok=True)

    slides = resolve_slides(config, limit=2 if args.quick else None)
    cfg = tile_config(config)
    model, patch_extract, masks = serving_encoder(config, device, slides, cfg, put=put)
    slide_tail = make_slide_tail(model)
    patch_dir = os.path.join(output_path or ".", "patch_features")
    save_patches = bool(config.get("save_patch_features", False))
    if save_patches:
        os.makedirs(patch_dir, exist_ok=True)

    rows, cases, embs = [], [], []
    for path, sid, case in slides:
        feats, locs = stream_slide_features(patch_extract, open_slide(path), cfg,
                                            config.batch_size, device, mask=masks.get(path),
                                            put=put)
        if not writes:
            continue
        if feats.shape[0] == 0:
            print(f"{sid}: no tissue tiles — skipped")
            continue
        emb, scores, attention = (t.cpu().numpy() for t in slide_tail(feats))
        row = {"slide": sid, "case": case, "n_patches": feats.shape[0], **score_columns(scores)}
        rows.append(row)
        cases.append(case)
        embs.append(emb)
        if save_patches:
            np.save(os.path.join(patch_dir, f"{sid}_features.npy"), feats.cpu().numpy())
            write_frame(os.path.join(patch_dir, f"{sid}_patches.csv"),
                        {"id": list(range(len(locs))), "x": [x for x, _ in locs],
                         "y": [y for _, y in locs],
                         "attention": [str(np.float32(a)) for a in attention]},
                        index=False)
        print(f"{sid}: {feats.shape[0]} patches, score {row.get('score', scores.tolist())}")

    if not writes:
        return
    if not rows:
        raise SystemExit("no slide produced any tissue tiles")
    suffix = f"_{flag}" if "cv" in flag else ""
    write_frame(os.path.join(output_path, f"slide_scores{suffix}.csv"), frame_of_rows(rows),
                index=False)
    uc, uf = extract_features_frames(cases, np.stack(embs))
    write_frame(os.path.join(output_path, f"pathology_cases_slides{suffix}.csv"), {"0": uc})
    np.savetxt(os.path.join(output_path, f"pathology_features_slides{suffix}.csv"), uf,
               delimiter=",")


if __name__ == "__main__":
    main()
