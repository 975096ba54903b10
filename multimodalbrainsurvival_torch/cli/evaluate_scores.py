"""Survival evaluation of savescore frames: KM, log-rank, bootstrap C-index.

The port's own copy of ``multimodalbrainsurvival_tpu/cli/evaluate_scores.py``
without pandas, with the bootstrap's pair counts on ``--device``
(``ops/survival.py::bootstrap_concordance``; ``cuda`` by default, which
raises without a card). The paper's downstream analysis (Steyaert et al.
2022), which the reference leaves to R / lifelines, as one command over the
frames every savescore CLI writes (``id, score, survival_months,
vital_status``):

- Harrell's C-index with a case-resampled bootstrap confidence interval;
- risk groups at the **median training score** (``--train_scores``;
  otherwise the evaluated frame's own median, and the report says which);
- Kaplan-Meier curves per risk group with Greenwood log-minus-log bands,
  each group's median survival, and the log-rank test between the groups;
- Cox proportional-hazards regression on the score per its standard
  deviation, univariable, and adjusted for clinical covariates with
  ``--cohort <csv> --covariates age,gender`` (joined ``id`` = ``case``;
  text columns dummy-coded as ``pd.get_dummies(drop_first=True)`` codes
  them: levels sorted, the first dropped, ``<col>_<level>``, after the
  other columns; rows with a missing covariate dropped first);
- IPCW Brier score / IBS (the score made a survival function by a
  one-covariate Cox fit, on the train frame when given) and
  cumulative/dynamic AUC(t), at the event-time percentiles or
  ``--eval_times 12,24,60``.

Per input frame ``<name>.csv``, under ``--output_dir``:
``evaluation_<name>.json`` (the report, also printed), ``km_<name>.csv``
(per-group KM curves), ``cox_<name>.csv`` (the Cox summary table) and,
with ``--plot 1``, ``km_<name>.png`` (matplotlib, imported only then).

    python -m multimodalbrainsurvival_torch.cli.evaluate_scores \\
        --scores val_df.csv test_df.csv --train_scores train_df.csv --device cpu
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import numpy as np

from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.frames import (
    as_text,
    is_missing,
    n_rows,
    read_frame,
    write_frame,
)
from multimodalbrainsurvival_torch.ops.survival import (
    bootstrap_concordance,
    brier_score,
    cox_ph,
    cumulative_dynamic_auc,
    default_eval_times,
    integrated_brier_score,
    kaplan_meier,
    logrank_test,
    risk_groups,
)

GROUP_NAMES = {0: "low", 1: "high"}
# low risk blue, high risk orange; light surface and ink
SERIES = {"low": "#2a78d6", "high": "#eb6834"}
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"


def _load_frame(path: str) -> dict:
    df = read_frame(path)
    missing = {"score", "survival_months", "vital_status"} - set(df)
    if missing:
        raise SystemExit(
            f"{path}: not a savescore frame — missing columns {sorted(missing)}"
        )
    return df


def _floats(values) -> np.ndarray:
    return np.asarray(values, np.float64)


def _events(values) -> np.ndarray:
    """``column.to_numpy().astype(bool)``; a ``True`` / ``False`` column
    (pandas reads it as bool) too."""
    return np.array([{"True": True, "False": False}.get(v, v) if isinstance(v, str) else v
                     for v in values]).astype(bool)


def _labels(df: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(scores, months, events) of a frame."""
    return (_floats(df["score"]), _floats(df["survival_months"]),
            _events(df["vital_status"]))


def evaluate_frame(df: dict, cutoff: float | None, n_boot: int, seed: int,
                   alpha: float = 0.05, device="cpu"):
    """Full survival report for one score frame. Returns (report,
    km_frame, curves)."""
    scores, months, events = _labels(df)

    boot = bootstrap_concordance(months, scores, events, n_boot=n_boot,
                                 alpha=alpha, seed=seed, device=device)
    cutoff_source = "self_median" if cutoff is None else "train_median"
    grp, cutoff = risk_groups(scores, cutoff=cutoff)

    report = {
        "n_cases": int(n_rows(df)),
        "n_events": int(events.sum()),
        **boot,
        "cutoff": cutoff,
        "cutoff_source": cutoff_source,
        "groups": {},
    }

    km_cols = ("group", "time", "survival", "ci_lower", "ci_upper", "at_risk", "observed")
    km_rows = []
    curves = {}
    for g in (0, 1):
        name = GROUP_NAMES[g]
        sel = grp == g
        if not sel.any():
            report["groups"][name] = {"n": 0, "events": 0, "median_survival": None}
            continue
        km = kaplan_meier(months[sel], events[sel], alpha=alpha)
        curves[name] = (km, months[sel], events[sel])
        med = km.median_survival
        report["groups"][name] = {
            "n": int(sel.sum()),
            "events": int(events[sel].sum()),
            "median_survival": med if np.isfinite(med) else None,
        }
        for i in range(km.time.size):
            km_rows.append((name, km.time[i], km.survival[i], km.ci_lower[i],
                            km.ci_upper[i], km.at_risk[i], km.observed[i]))

    if len(curves) == 2:
        lr = logrank_test(months, events, grp)
        report["logrank_chi2"] = lr.chi2
        report["logrank_p"] = lr.p_value
    else:
        report["logrank_chi2"] = report["logrank_p"] = None

    km_frame = {c: [r[j] for r in km_rows] for j, c in enumerate(km_cols)} if km_rows else {}
    return report, km_frame, curves


def dummy_code(df: dict, cols: list, keep: np.ndarray) -> tuple[np.ndarray, list]:
    """``pd.get_dummies(df.loc[keep, cols], drop_first=True,
    dtype=float64)`` as ``(matrix, names)``: a text column becomes one
    0/1 column per level but its first (levels sorted), named
    ``<col>_<level>``, after every uncoded column in the order given; a
    ``True`` / ``False`` column (pandas' bool) is a number."""
    rows = np.flatnonzero(keep)
    plain, coded = [], []
    for c in cols:
        values = [df[c][i] for i in rows]
        if all(isinstance(v, (int, float)) for v in df[c]):
            plain.append((c, np.asarray(values, np.float64)))
        elif set(df[c]) <= {"True", "False"}:
            plain.append((c, np.array([v == "True" for v in values], np.float64)))
        else:
            for level in sorted(set(values))[1:]:
                coded.append((f"{c}_{level}",
                              np.array([v == level for v in values], np.float64)))
    names = [name for name, _ in plain + coded]
    X = (np.column_stack([v for _, v in plain + coded]) if names
         else np.empty((rows.size, 0)))
    return X, names


def cox_models(df: dict, covariate_cols: list) -> tuple[dict, dict]:
    """Univariable (score only) + optional adjusted Cox PH fits.

    The score enters **per its own standard deviation** so the hazard ratio
    reads "per 1 SD of model risk score", comparable across pipelines whose
    raw score scales differ. Text covariates are dummy-coded (the first
    level is the reference); rows with a missing covariate drop, with a
    recorded count. Returns (report, cox table)."""
    score, months, events = _labels(df)
    sd = score.std()
    score_per_sd = score / sd if sd > 0 else score

    out: dict = {}
    rows = []

    def _fit(tag, X, names, t, e):
        try:
            fit = cox_ph(t, e, X, names=names)
        except (ValueError, np.linalg.LinAlgError) as err:
            out[tag] = {"error": str(err)}
            return
        out[tag] = {
            "covariates": fit.summary_rows(),
            "lr_chi2": fit.lr_chi2,
            "lr_p": fit.lr_p,
            "log_likelihood": fit.log_likelihood,
            "n": fit.n,
            "n_events": fit.n_events,
            "ties": fit.ties,
            "converged": fit.converged,
        }
        for r in fit.summary_rows():
            rows.append({"model": tag, **r})

    _fit("cox_univariable", score_per_sd[:, None], ["score_per_sd"], months, events)

    if covariate_cols:
        # the missing-row mask comes BEFORE the coding: get_dummies codes
        # a missing text value as the reference level (an all-zero row)
        keep = ~np.array([any(is_missing(df[c][i]) for c in covariate_cols)
                          for i in range(n_rows(df))], bool).reshape(-1)
        dropped = int((~keep).sum())
        covs, names = dummy_code(df, covariate_cols, keep)
        X = np.column_stack([score_per_sd[keep], covs])
        _fit("cox_adjusted", X, ["score_per_sd"] + names, months[keep], events[keep])
        if isinstance(out.get("cox_adjusted"), dict):
            out["cox_adjusted"]["n_dropped_missing"] = dropped

    table = {c: [r[c] for r in rows] for c in rows[0]} if rows else {}
    return out, table


def time_dependent_report(df: dict, train_df: dict | None,
                          eval_times: np.ndarray | None) -> dict:
    """IPCW Brier/IBS + cumulative/dynamic AUC(t) for one score frame.

    The scalar risk score becomes a survival function through a
    one-covariate Cox model (S(t|score) = exp(-H0(t) e^{beta*score}),
    Breslow baseline): fitted on the TRAIN frame when given (calibration
    measured out of sample), else on the evaluated frame (recorded as
    such). The censoring distribution G is always estimated on the
    evaluated frame. AUC(t) uses the raw scores.
    """
    score, months, events = _labels(df)
    fit_score, fit_months, fit_events = _labels(train_df if train_df is not None else df)
    try:
        fit = cox_ph(fit_months, fit_events, fit_score[:, None], names=["score"])
    except (ValueError, np.linalg.LinAlgError) as err:
        return {"error": f"calibration Cox fit failed: {err}"}

    taus = (np.asarray(eval_times, np.float64) if eval_times is not None
            else default_eval_times(months, events))
    if taus.size == 0:
        return {"error": "no valid evaluation times (degenerate cohort)"}
    try:
        surv = fit.predict_survival(score[:, None], taus)
        auc, mean_auc = cumulative_dynamic_auc(months, events, score, taus)
        out = {
            "eval_times": [float(x) for x in taus],
            "auc": [float(x) if np.isfinite(x) else None for x in auc],
            "mean_auc": float(mean_auc) if np.isfinite(mean_auc) else None,
            "brier": [float(x) for x in brier_score(months, events, surv, taus)],
            "calibration": "train_cox" if train_df is not None else "self_cox",
        }
        if taus.size >= 2:
            out["ibs"] = integrated_brier_score(months, events, surv, taus)
        return out
    except ValueError as err:
        return {"error": str(err)}


def plot_km(curves: dict, report: dict, out_png: str, title: str) -> None:
    """KM step plot: the two groups, Greenwood bands, censor ticks, legend,
    a light grid, one axis. Imports matplotlib (not a dependency of the
    port) when called."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7.0, 4.6), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    ax.set_facecolor(SURFACE)

    t_max = 0.0
    for name, (km, months, events) in curves.items():
        color = SERIES[name]
        # right-continuous step curve anchored at S(0)=1
        xs = np.concatenate([[0.0], km.time])
        ys = np.concatenate([[1.0], km.survival])
        ax.step(xs, ys, where="post", color=color, lw=2.0,
                label=f"{name} risk (n={report['groups'][name]['n']})",
                solid_capstyle="butt", zorder=3)
        finite = np.isfinite(km.ci_lower) & np.isfinite(km.ci_upper)
        if finite.any():
            ax.fill_between(km.time[finite], km.ci_lower[finite],
                            km.ci_upper[finite], step="post",
                            color=color, alpha=0.14, lw=0, zorder=2)
        cens = np.sort(months[~events])
        if cens.size:
            ax.plot(cens, km.step_function(cens), linestyle="none",
                    marker="|", markersize=7, markeredgewidth=1.2,
                    color=color, zorder=4)
        t_max = max(t_max, float(months.max()))

    p = report.get("logrank_p")
    if p is not None:
        label = f"log-rank p = {p:.2e}" if p < 1e-3 else f"log-rank p = {p:.3f}"
        ax.text(0.985, 0.97, label, transform=ax.transAxes,
                ha="right", va="top", fontsize=9, color=INK_2)

    ax.set_xlim(0, t_max * 1.02 if t_max else 1.0)
    ax.set_ylim(0.0, 1.02)
    ax.set_xlabel("Time (months)", color=INK)
    ax.set_ylabel("Survival probability", color=INK)
    ax.set_title(title, color=INK, fontsize=11, loc="left")
    ax.grid(axis="y", color="#e4e3df", lw=0.8, zorder=1)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(INK_2)
    ax.tick_params(colors=INK_2, labelsize=9)
    leg = ax.legend(loc="lower left", frameon=False, fontsize=9)
    for text in leg.get_texts():
        text.set_color(INK)
    fig.tight_layout()
    fig.savefig(out_png, facecolor=SURFACE)
    plt.close(fig)


def load_cohort(path: str, covariate_cols: list) -> dict:
    """The cohort's ``case`` (as text) and covariate columns, each case
    once (its first row)."""
    cohort = read_frame(path)
    missing = set(covariate_cols + ["case"]) - set(cohort)
    if missing:
        raise SystemExit(f"{path}: missing column(s) {sorted(missing)}")
    cases = as_text(cohort["case"])
    first: dict = {}
    for i, c in enumerate(cases):
        first.setdefault(c, i)
    if len(first) < len(cases):
        print(f"# {path}: {len(cases) - len(first)} duplicate case row(s) dropped "
              f"(keeping first) — duplicates would replicate score rows "
              f"and understate Cox SEs")
    rows = sorted(first.values())
    return {"case": [cases[i] for i in rows],
            **{c: [cohort[c][i] for i in rows] for c in covariate_cols}}


def join_cohort(df: dict, cohort: dict) -> dict:
    """``df.assign(id=df["id"].astype(str)).merge(cohort, left_on="id",
    right_on="case", how="inner")``: the frame's rows in order, those with
    a cohort case, and the cohort's columns after the frame's (``_x`` /
    ``_y`` on a name in both)."""
    df = dict(df, id=as_text(df["id"]))
    where = {c: j for j, c in enumerate(cohort["case"])}
    pairs = [(i, where[c]) for i, c in enumerate(df["id"]) if c in where]
    both = set(df) & set(cohort)
    out = {(f"{c}_x" if c in both else c): [v[i] for i, _ in pairs] for c, v in df.items()}
    out.update({(f"{c}_y" if c in both else c): [v[j] for _, j in pairs]
                for c, v in cohort.items()})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scores", nargs="+", required=True,
                   help="savescore frame(s) to evaluate (val/test splits)")
    p.add_argument("--train_scores", default="",
                   help="train-split frame; fixes the risk cutoff at ITS "
                        "median score (the paper's protocol)")
    p.add_argument("--output_dir", default="evaluation")
    p.add_argument("--n_boot", type=int, default=1000,
                   help="bootstrap resamples for the C-index CI")
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plot", type=int, default=0,
                   help="1 = also write km_<name>.png (needs matplotlib)")
    p.add_argument("--cohort", default="",
                   help="cohort CSV (reference ExampleData schema, `case` "
                        "ids) providing clinical covariates to adjust for")
    p.add_argument("--covariates", default="",
                   help="comma-separated cohort columns for the adjusted "
                        "Cox model (e.g. age,gender)")
    p.add_argument("--eval_times", default="",
                   help="comma-separated horizons (months) for the "
                        "time-dependent Brier/AUC metrics; default = "
                        "percentiles 10..90 of the frame's event times")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the bootstrap counts: cuda (default; raises "
                        "without a card) or cpu")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    if a.plot and importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("--plot 1 needs matplotlib, which is not installed")

    covariate_cols = [c for c in a.covariates.split(",") if c]
    cohort = None
    if covariate_cols:
        if not a.cohort:
            raise SystemExit("--covariates needs --cohort")
        cohort = load_cohort(a.cohort, covariate_cols)

    cutoff = None
    train_df = None
    if a.train_scores:
        train_df = _load_frame(a.train_scores)
        cutoff = float(np.median(_floats(train_df["score"])))
    eval_times = (np.array(sorted(float(x) for x in a.eval_times.split(",") if x))
                  if a.eval_times else None)

    os.makedirs(a.output_dir, exist_ok=True)
    for path in a.scores:
        name = os.path.splitext(os.path.basename(path))[0]
        df = _load_frame(path)
        report, km_frame, curves = evaluate_frame(
            df, cutoff, n_boot=a.n_boot, seed=a.seed, alpha=a.alpha, device=device)
        cox_df = df
        if cohort is not None:
            cox_df = join_cohort(df, cohort)
            if n_rows(cox_df) < n_rows(df):
                print(f"# {name}: {n_rows(df) - n_rows(cox_df)} score rows have "
                      f"no cohort match on id=case")
        cox_report, cox_table = cox_models(cox_df, covariate_cols)
        report.update(cox_report)
        report["time_dependent"] = time_dependent_report(df, train_df, eval_times)
        if cox_table:
            cox_path = os.path.join(a.output_dir, f"cox_{name}.csv")
            write_frame(cox_path, cox_table, index=False)
            print(f"wrote {cox_path}")
        report_path = os.path.join(a.output_dir, f"evaluation_{name}.json")
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
        km_path = os.path.join(a.output_dir, f"km_{name}.csv")
        write_frame(km_path, km_frame, index=False)
        print(f"{name}: C-index {report['c_index']:.3f} "
              f"[{report['ci_lower']:.3f}, {report['ci_upper']:.3f}] "
              f"(n={report['n_cases']}, events={report['n_events']}); "
              f"log-rank p={report['logrank_p']}")
        uni = report.get("cox_univariable", {})
        for r in uni.get("covariates", []):
            print(f"{name}: Cox HR per score SD {r['hr']:.3f} "
                  f"[{r['hr_ci_lower']:.3f}, {r['hr_ci_upper']:.3f}], "
                  f"p={r['p']:.3g}")
        td = report["time_dependent"]
        if "error" not in td:
            mean_auc = td["mean_auc"]
            ibs = td.get("ibs")
            print(f"{name}: mean AUC(t) "
                  + (f"{mean_auc:.3f}" if mean_auc is not None else "n/a")
                  + (f", IBS {ibs:.4f}" if ibs is not None else "")
                  + f" over {len(td['eval_times'])} horizons "
                    f"({td['calibration']})")
        adj = report.get("cox_adjusted", {})
        for r in adj.get("covariates", []):
            print(f"{name}: adjusted Cox {r['covariate']}: HR {r['hr']:.3f} "
                  f"[{r['hr_ci_lower']:.3f}, {r['hr_ci_upper']:.3f}], "
                  f"p={r['p']:.3g}")
        print(f"wrote {report_path}")
        print(f"wrote {km_path}")
        if a.plot:
            png_path = os.path.join(a.output_dir, f"km_{name}.png")
            plot_km(curves, report, png_path, title=name)
            print(f"wrote {png_path}")


if __name__ == "__main__":
    main()
