"""Hyperparameter sweep of any trainable pipeline.

The port's own copy of ``multimodalbrainsurvival_tpu/cli/sweep.py``,
without pandas, with ``--device`` passed to every train run (``cuda`` by
default, which raises without a card). The reference selects models by
hand-edited configs run one at a time (its per-module LRs, ``lr_histo`` /
``lr_rna`` / ``lr_mlp``, are the knobs its paper tunes); this CLI runs the
whole grid with one command, for any of the four trainable pipelines::

    python -m multimodalbrainsurvival_torch.cli.sweep \\
        --config config_rna_train.json --task rna \\
        --grid '{"lr_rna": [1e-4, 1e-5], "dropout": [0.3, 0.5]}'

- ``--grid`` is inline JSON ``{key: [values...]}`` or a JSON file's path;
  the config key ``sweep_grid`` overrides it. Keys are train-config keys,
  checked against ``config.KNOWN_KEYS`` first: a misspelt key would train
  N identical models and "select" a winner from noise.
- Combination c (1-based, the cartesian product in sorted-key order)
  trains under ``flag: "<flag>_hp{c}"``, in the usual per-flag layout.
- Selection: the **validation** C-index of the best checkpoint's frame
  (``outputs/<flag>_hp{c}/val_output_best.csv``); the test C-index is
  recorded beside it and never selects.
- ``<checkpoint_path>/sweep_summary.csv`` (a row a combination, ranked)
  and ``<checkpoint_path>/sweep_best_config.json`` (the winner's merged
  config under the original flag, ready to re-run or hand to ``cv_run``).

Ranking: a full grid ranks by ``val_CI`` alone (descending, missing last,
ties in combination order), whatever ``num_epochs`` each combination
trained; only ``--halving`` ranks by ``epochs_trained`` first, where the
epochs mark the rungs' survivors. (The JAX CLI sorts by
``epochs_trained`` first in both modes, so a full grid over
``num_epochs`` lists the longest runs first whatever their C-index; the
port does not copy that.)

Budgeted modes:

- ``--max_trials N`` trains a seeded (``--seed``) random subset of N
  combinations, and names the dropped ones first;
- ``--halving ETA`` (>= 2) is successive halving: every combination
  trains a small epoch budget, then the top ``1/eta`` by val C-index
  continue (``resume: true``: the full train state, optimizer moments and
  the best checkpoint's race included, so no epoch is retrained) to an
  ``eta``-times larger budget, until one finishes the config's
  ``num_epochs``.

In a world (a ``mesh`` of N ranks under ``python -m
torch.distributed.run --nproc_per_node N``) every rank runs the sweep and
the train CLIs in-process in that world; rank 0 writes the configs and
the summaries, the others waiting for its configs, and every rank ranks
by rank 0's C-indices, so all take the same halving decisions.
"""

from __future__ import annotations

import itertools
import json
import math
import os

import numpy as np

from multimodalbrainsurvival_torch.cli._common import (
    load_config,
    make_device_put,
    make_parser,
)
from multimodalbrainsurvival_torch.cli.cv_run import TASKS, frame_ci, task_mains
from multimodalbrainsurvival_torch.config import KNOWN_KEYS
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import read_frame, records_frame, write_frame
from multimodalbrainsurvival_torch.parallel.mesh import world_barrier


def _normalize_grid(grid: dict, origin: str) -> dict:
    """Scalar values become one-element lists (``{"lr": 1e-4}`` pins a key
    across the sweep); an empty value list (zero combinations) and a key
    outside ``KNOWN_KEYS`` are rejected up front."""
    if not isinstance(grid, dict) or not grid:
        raise SystemExit(f"{origin}: grid must be a non-empty JSON object")
    out = {}
    for k, v in grid.items():
        v = v if isinstance(v, list) else [v]
        if not v:
            raise SystemExit(
                f"{origin}: key {k!r} has an empty value list — every grid "
                "key needs at least one value")
        out[k] = v
    unknown = sorted(k for k in out if k not in KNOWN_KEYS)
    if unknown:
        raise SystemExit(
            f"{origin}: grid key(s) {unknown} are not recognized "
            "train-config keys — a typo here would train "
            "identical models and select a winner from noise "
            "(see multimodalbrainsurvival_torch.config.KNOWN_KEYS)")
    return out


def parse_grid(spec: str) -> dict:
    """``--grid`` inline-JSON-or-path → {key: [values]}."""
    if not spec:
        raise SystemExit("--grid (or config sweep_grid) is required")
    if os.path.isfile(spec):
        with open(spec) as f:
            grid = json.load(f)
        return _normalize_grid(grid, spec)
    try:
        grid = json.loads(spec)
    except json.JSONDecodeError as err:
        raise SystemExit(f"--grid is neither a file nor JSON: {err}")
    return _normalize_grid(grid, "--grid")


def combinations(grid: dict) -> list[dict]:
    keys = sorted(grid)
    return [dict(zip(keys, values))
            for values in itertools.product(*(grid[k] for k in keys))]


def subsample(combos: list[dict], max_trials: int, seed: int) -> list[dict]:
    """Seeded random subset of the grid (``--max_trials``), the JAX
    package's draw; the combinations in their original order."""
    if max_trials <= 0 or max_trials >= len(combos):
        return combos
    rng = np.random.default_rng(seed)
    keep = sorted(rng.choice(len(combos), size=max_trials, replace=False))
    dropped = len(combos) - max_trials
    print(f"--max_trials {max_trials}: sampling {max_trials}/{len(combos)} "
          f"combinations (seed {seed}); dropping {dropped}: "
          + "; ".join(
              ", ".join(f"{k}={v}" for k, v in sorted(combos[i].items()))
              for i in range(len(combos)) if i not in set(keep)))
    return [combos[i] for i in keep]


def halving_rungs(n_combos: int, num_epochs: int, eta: int) -> list[int]:
    """Cumulative epoch targets for successive halving: the first rung
    trains ``max(1, R // eta**k)`` epochs (k = rounds needed to shrink
    ``n_combos`` to 1 by keep-top-``1/eta``), each later rung eta-times
    more, the last always the full ``R = num_epochs``."""
    if n_combos <= 1:
        return [num_epochs]
    k = max(1, math.ceil(math.log(n_combos, eta)))
    targets = [max(1, num_epochs // eta**i) for i in range(k, 0, -1)] + [num_epochs]
    # strictly increasing (tiny num_epochs can collapse early rungs)
    out = []
    for t in targets:
        if not out or t > out[-1]:
            out.append(t)
    return out


def _ci_of(output_dir: str, split: str):
    path = os.path.join(output_dir, f"{split}_output_best.csv")
    if not os.path.isfile(path):
        return None
    frame = read_frame(path)
    if not {"score", "survival_months", "vital_status"} <= set(frame):
        return None  # classification task: no survival frame to rank
    return frame_ci(frame)


def _missing(ci) -> bool:
    return ci is None or math.isnan(ci)


def rank(records: list[dict], halving: bool) -> list[dict]:
    """The summary's order: ``val_CI`` descending with the missing last,
    ties in combination order; under ``--halving`` by ``epochs_trained``
    (descending) first."""
    def key(r):
        ci = -math.inf if _missing(r["val_CI"]) else r["val_CI"]
        return (r["epochs_trained"], ci) if halving else (ci,)

    return sorted(records, key=key, reverse=True)


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--task", type=str, required=True,
                        help=f"pipeline to sweep: {'/'.join(TASKS)}")
    parser.add_argument("--grid", type=str, default="",
                        help="JSON object {config_key: [values...]} or a "
                             "path to one (config sweep_grid overrides)")
    parser.add_argument("--max_trials", type=int, default=0,
                        help="train only a seeded random subset of N "
                             "combinations (0 = the full grid)")
    parser.add_argument("--halving", type=int, default=0,
                        help="successive-halving factor eta (>=2): short "
                             "budgets for all combos, top-1/eta continue "
                             "via resume until one finishes num_epochs "
                             "(0 = off, train every combo fully)")
    args = parser.parse_args(argv)
    if args.halving == 1 or args.halving < 0:
        raise SystemExit("--halving must be 0 (off) or an eta >= 2")
    device = resolve_device(args.device)
    train_main, _ = task_mains(args.task)
    config, flag = load_config(args)
    put, _, flag = make_device_put(config, device, flag)
    writes = put is None or put.mesh.rank == 0
    checkpoint_path = config.get("checkpoint_path", "checkpoints/")
    if config.get("sweep_grid"):
        grid = _normalize_grid(config["sweep_grid"], "config sweep_grid")
    else:
        grid = parse_grid(args.grid)
    combos = subsample(combinations(grid), args.max_trials, args.seed)
    num_epochs = config.num_epochs

    child_args = ["--seed", str(args.seed), "--device", args.device]
    if args.quick:
        child_args += ["--quick", "1"]

    sweep_dir = os.path.join(checkpoint_path, "sweep")
    if writes:
        os.makedirs(sweep_dir, exist_ok=True)

    # combo id -> record; ids are 1-based positions in the (possibly
    # subsampled) combo list, so flags stay the same across rungs
    records = {c: {"combo": c, "flag": f"{flag}_hp{c}", **overrides,
                   "epochs_trained": 0, "val_CI": None, "test_CI": None}
               for c, overrides in enumerate(combos, start=1)}

    def run_combo(c: int, overrides: dict, target_epochs=None,
                  resume: bool = False) -> None:
        """Train one combo. ``target_epochs`` is set by the halving rungs
        only; a full grid leaves the combo's own overrides (which may
        sweep ``num_epochs``) as they are."""
        flag_c = records[c]["flag"]
        raw = {k: v for k, v in dict(config.raw).items() if k != "sweep_grid"}
        raw.update(overrides, flag=flag_c)
        if target_epochs is not None:  # halving controls the budget
            raw.update(num_epochs=target_epochs, resume=bool(resume))
        cfg_path = os.path.join(sweep_dir, f"config_hp{c}.json")
        if writes:
            with open(cfg_path, "w") as fh:
                json.dump(raw, fh, indent=2)
        world_barrier(device)  # every rank's train CLI reads it
        train_main(["--config", cfg_path] + child_args)
        records[c]["epochs_trained"] = (
            target_epochs if target_epochs is not None
            else int(raw.get("num_epochs", num_epochs)))
        output_dir = os.path.join(checkpoint_path, "outputs", flag_c)
        cis = (_ci_of(output_dir, "val"), _ci_of(output_dir, "test")) if writes else None
        if put is not None:  # rank 0 wrote the frames: its reading ranks
            cis = put.mesh.broadcast_object(cis)
        records[c]["val_CI"], records[c]["test_CI"] = cis

    summary_path = os.path.join(checkpoint_path, "sweep_summary.csv")
    if args.halving:
        if "num_epochs" in grid:
            raise SystemExit(
                "--halving controls each combo's epoch budget itself — "
                "sweeping num_epochs at the same time is contradictory; "
                "drop it from the grid or run without --halving")
        if config.get("task", "survival_prediction") == "classification":
            raise SystemExit(
                "--halving ranks combos by the survival val C-index, which "
                "a classification task does not produce — run the full "
                "grid instead")
        rungs = halving_rungs(len(combos), num_epochs, args.halving)
        print(f"successive halving (eta={args.halving}): "
              f"{len(combos)} combos, cumulative epoch targets {rungs}")
        alive = list(records)  # combo ids still in the race
        for r, target in enumerate(rungs):
            for c in alive:
                print(f"=== halving rung {r + 1}/{len(rungs)} "
                      f"(-> epoch {target}): combo {c} "
                      + ", ".join(f"{k}={v}" for k, v in sorted(combos[c - 1].items()))
                      + f" (flag {records[c]['flag']}) ===")
                run_combo(c, combos[c - 1], target, resume=r > 0)
            if r == len(rungs) - 1:
                break
            if all(records[c]["val_CI"] is None for c in alive):
                # the completed rung's work is kept before stopping
                if writes:
                    write_frame(summary_path, records_frame(list(records.values())),
                                index=False)
                raise SystemExit(
                    "--halving: no combo produced a survival val score "
                    "frame to rank by after rung 1 (partial results in "
                    "sweep_summary.csv) — run the full grid instead")
            ranked_alive = sorted(
                alive,
                key=lambda c: (records[c]["val_CI"] is not None,
                               records[c]["val_CI"] or 0.0),
                reverse=True)
            keep = max(1, math.ceil(len(alive) / args.halving))
            cut = ranked_alive[keep:]
            alive = sorted(ranked_alive[:keep])
            if cut:
                print(f"halving rung {r + 1}: keep {alive} "
                      f"(top {keep} by val CI), cut {sorted(cut)}")
    else:
        for c, overrides in enumerate(combos, start=1):
            print(f"=== sweep {c}/{len(combos)}: "
                  + ", ".join(f"{k}={v}" for k, v in sorted(overrides.items()))
                  + f" (flag {records[c]['flag']}) ===")
            run_combo(c, overrides)

    if not writes:
        return
    ranked = rank(list(records.values()), halving=bool(args.halving))
    write_frame(summary_path, records_frame(ranked), index=False)
    print(f"wrote {summary_path}")
    total = sum(r["epochs_trained"] for r in ranked)
    print(f"sweep epoch-units trained: {total} "
          f"(full grid would be {len(combos) * num_epochs})")
    best = ranked[0]
    if not _missing(best["val_CI"]):
        best_overrides = {k: combos[best["combo"] - 1][k] for k in grid}
        print("sweep best (by val CI): "
              + ", ".join(f"{k}={v}" for k, v in sorted(best_overrides.items()))
              + f" -> val CI {best['val_CI']:.4f}")
        best_raw = {k: v for k, v in dict(config.raw).items() if k != "sweep_grid"}
        best_raw.update(best_overrides)  # the winner's knobs, the original flag
        best_path = os.path.join(checkpoint_path, "sweep_best_config.json")
        with open(best_path, "w") as fh:
            json.dump(best_raw, fh, indent=2)
        print(f"wrote {best_path}")
    else:
        print("sweep: no survival val frames to rank "
              "(classification task or skipped savescore)")


if __name__ == "__main__":
    main()
