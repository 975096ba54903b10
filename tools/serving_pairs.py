"""Time the histopathology serving CLI of two checkouts in alternating pairs
on one card.

``histo_extractfeatures`` runs at the main path's width (ResNet-50,
attention 2048, bfloat16, 224 px, bags of 16, batch 16) in its three modes:
floating point, ``quantize: "int8"`` and ``fold_bn: true``. It runs from
this checkout (``change``) and from another one (``--parent DIR``, an
earlier commit unpacked with ``git archive``), each in a process of its
own that imports the package from its tree, in the order parent, change,
change, parent, ``--rounds`` times. Every process reads one synthetic
cohort (``--slides`` slides x 64 patches, made from a seed, every slide in
each of the three splits) and one random model. It runs each mode once
untimed (kernel builds, cuDNN set-up), then ``--runs`` timed CLI runs of
each mode in turn (wall clock with the card synchronized: model load,
calibration and host reads included). On one batch it also times the
aggregator's call under ``inference_mode`` (host wall per call, 500 calls,
synchronized at the end) and the host's read of the val split's batches.

Prints one JSON line per process, then the medians per tree and mode, with
the card's name and power limit. Run from the root of the repository, on a
machine with a card:

    python tools/serving_pairs.py --parent DIR [--rounds 1] [--runs 3]
        [--slides 32]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
MODES = ("bf16", "int8", "bf16_folded")
RESULT = "SERVING_PAIRS_RESULT "


def make_cohort(root: str, n_slides: int, n_patch: int, img: int, seed: int) -> str:
    """``n_slides`` slides of ``n_patch`` random patches as packed shards
    with their loc.txt, one case each; returns the cohort CSV's path."""
    rng = np.random.default_rng(seed)
    rows = ["case,survival_months,vital_status,wsi_file_name"]
    for i in range(n_slides):
        wsi = f"S{i}"
        d = os.path.join(root, "patches", wsi)
        os.makedirs(d)
        with open(os.path.join(d, "loc.txt"), "w") as f:
            f.write(f"slide_id {wsi}\nid x y patch_level patch_size_read "
                    "patch_size_output\n")
            f.writelines(f"{j} {j * img} 0 0 {img} {img}\n" for j in range(n_patch))
        np.save(os.path.join(d, "patches.npy"),
                rng.integers(0, 256, (n_patch, img, img, 3), dtype=np.uint8))
        rows.append(f"c{i},{rng.uniform(1, 120):.4f},{int(rng.integers(0, 2))},{wsi}.svs")
    csv_path = os.path.join(root, "cohort.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path


def prepare(root: str, n_slides: int) -> dict[str, str]:
    """The cohort, the random model and one config per mode; returns each
    mode's config path."""
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from multimodalbrainsurvival_torch.cli._common import build_mil_model
    from multimodalbrainsurvival_torch.config import Config

    csv_path = make_cohort(root, n_slides, cs.N_PATCH, cs.IMG, cs.SEED)
    cfg, path = cs._config(root, csv_path, "bf16")
    torch.save(cs.random_state_dict(build_mil_model(Config(cfg)), cs.SEED),
               cfg["model_path"])
    paths = {"bf16": path}
    for mode, key in (("int8", {"quantize": "int8"}), ("bf16_folded", {"fold_bn": True})):
        paths[mode] = cs._config(root, csv_path, mode,
                                 output_path=os.path.join(root, f"out_{mode}"), **key)[1]
    return paths


def worker(tree: str, configs: dict[str, str], runs: int) -> dict:
    """In a process that imports the package from ``tree``: the timed CLI
    runs of every mode, the aggregator's call and the host read."""
    sys.path.insert(0, tree)
    import torch

    from multimodalbrainsurvival_torch.cli import histo_extractfeatures
    from multimodalbrainsurvival_torch.cli._common import load_mil_model
    from multimodalbrainsurvival_torch.cli.histo_train import build_datasets
    from multimodalbrainsurvival_torch.config import Config
    from multimodalbrainsurvival_torch.train.adapters import MILAdapter

    import multimodalbrainsurvival_torch
    if not multimodalbrainsurvival_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {multimodalbrainsurvival_torch.__file__}, not {tree}")
    device = torch.device("cuda")

    def run(mode: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        histo_extractfeatures.main(["--config", configs[mode]])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for mode in MODES:
        run(mode)
    walls = {mode: [] for mode in MODES}
    for _ in range(runs):
        for mode in MODES:
            walls[mode].append(run(mode))

    with open(configs["bf16"]) as f:
        config = Config(json.load(f))
    model = load_mil_model(config, device)
    adapter = MILAdapter(model=model, device=device)
    val = build_datasets(config, False)["val"]
    n_patches = 3 * len(val) * config["val_bag_size"]  # three splits, one cohort
    arrays = adapter.to_device(next(iter(val.batches(config.batch_size))),
                               adapter.array_keys)
    with torch.inference_mode():
        feats = model.patch_features(adapter.inputs(arrays))
        mask = arrays["bag_mask"]
        for _ in range(20):
            model.aggregator(feats, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            model.aggregator(feats, mask)
        torch.cuda.synchronize()
        pool_us = (time.perf_counter() - t0) / 500 * 1e6
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in val.batches(config.batch_size, num_threads=8))
    read_ms = (time.perf_counter() - t0) / n_batches * 1e3
    return {"walls_s": walls, "patches_per_run": n_patches,
            "pool_call_us": pool_us, "host_read_ms_per_batch": read_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the checkout to compare against")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--slides", type=int, default=32)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--configs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        rec = worker(args.worker, json.loads(args.configs), args.runs)
        print(RESULT + json.dumps(rec), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    trees = {"parent": str(Path(args.parent).resolve()), "change": str(REPO)}
    results = {name: [] for name in trees}
    with tempfile.TemporaryDirectory() as root:
        configs = prepare(root, args.slides)
        for _ in range(args.rounds):
            for name in ("parent", "change", "change", "parent"):
                out = subprocess.run(
                    [sys.executable, __file__, "--worker", trees[name],
                     "--configs", json.dumps(configs), "--runs", str(args.runs)],
                    capture_output=True, text=True, cwd=trees[name])
                if out.returncode != 0:
                    sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
                    raise RuntimeError(f"{name} worker exited {out.returncode}")
                rec = json.loads(next(line for line in out.stdout.splitlines()
                                      if line.startswith(RESULT))[len(RESULT):])
                print(f"{name}: {json.dumps(rec)}", flush=True)
                results[name].append(rec)
    summary = {}
    for name, recs in results.items():
        n = recs[0]["patches_per_run"]
        summary[name] = {
            **{f"{mode}_patches_per_s_median": n / statistics.median(
                w for r in recs for w in r["walls_s"][mode]) for mode in MODES},
            "pool_call_us_median": statistics.median(r["pool_call_us"] for r in recs),
            "host_read_ms_per_batch_median": statistics.median(
                r["host_read_ms_per_batch"] for r in recs),
            "runs_per_mode": sum(len(r["walls_s"]["bf16"]) for r in recs),
        }
    print(json.dumps({"serving_pairs": summary, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
