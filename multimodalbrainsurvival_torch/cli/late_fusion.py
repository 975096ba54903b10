"""Late fusion: a cross-validated Cox elastic net over the unimodal scores.

Parity with ``4_LateFusion/2_LateFusion.R`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/late_fusion.py:23-72``, without pandas:
reads the merged score frames (``combined_score_{train,val}.csv`` from
``merge_scores``), fits ``cv.glmnet(family='cox')`` (``ops/coxnet.py``) on
the ``--covariates`` by name (the R script's ``[, c(2,6)]``), prints
λ.min and β, writes ``model_late_{train,val}.csv`` with the linear score at
λ.min appended as ``score``, and prints each split's C-index. The fit runs
on ``--device`` (``cuda`` unless ``--device cpu``; raises without a card).

    python -m multimodalbrainsurvival_torch.cli.late_fusion \
        --train_csv combined_score_train.csv --val_csv combined_score_val.csv \
        --output_dir late/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import read_frame, write_frame
from multimodalbrainsurvival_torch.ops.coxnet import fit_coxnet
from multimodalbrainsurvival_torch.ops.metrics import concordance_index


def _columns(frame: dict, names) -> np.ndarray:
    return np.stack([np.asarray(frame[c], np.float64) for c in names], axis=1)


def run_late_fusion(
    train_csv: str,
    val_csv: str,
    output_dir: str = ".",
    covariates: tuple = ("path_score", "rna_score"),
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    device = resolve_device(device)
    train = read_frame(train_csv)
    val = read_frame(val_csv)
    cov = list(covariates)

    fit = fit_coxnet(
        _columns(train, cov),
        np.asarray(train["survival_months"], np.float64),
        np.asarray(train["vital_status"], np.float64),
        seed=seed,
        device=device,
    )
    stats = fit.stats
    print(f"lambda.min = {fit.lambda_min:.5f}, beta = "
          f"{ {c: float(b) for c, b in zip(cov, fit.beta)} }")
    print(f"coxnet fit on {stats['device']}: {stats['problems']} problems x "
          f"{len(fit.lambdas)} lambdas, {stats['graph_replays']} CUDA graph replays, "
          f"{stats['seconds']:.3f} s")

    results = {}
    for name, frame in (("train", train), ("val", val)):
        scores = fit.predict(_columns(frame, cov))
        out = dict(frame)
        out["score"] = scores.tolist()
        path = os.path.join(output_dir, f"model_late_{name}.csv")
        write_frame(path, out, index=False)
        ci = concordance_index(np.asarray(frame["survival_months"], np.float64), -scores,
                               np.asarray(frame["vital_status"]).astype(bool))
        print(f"late fusion {name} CI = {ci:.3f} -> {path}")
        results[name] = {"ci": ci, "frame": out}
    results["fit"] = fit
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train_csv", default="combined_score_train.csv")
    p.add_argument("--val_csv", default="combined_score_val.csv")
    p.add_argument("--output_dir", default=".")
    p.add_argument("--covariates", nargs="+", default=["path_score", "rna_score"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    os.makedirs(a.output_dir, exist_ok=True)
    return run_late_fusion(a.train_csv, a.val_csv, a.output_dir, tuple(a.covariates),
                           a.seed, a.device)


if __name__ == "__main__":
    main()
