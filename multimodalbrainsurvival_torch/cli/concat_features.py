"""Concatenate RNA and pathology embeddings into the early-fusion table.

Parity with ``3_EarlyFusion/1_Concat2Features.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/concat_features.py:21-48``, without
pandas. It reads what the extract CLIs write: the cases files
(``rna_cases_<split>.csv``, ``pathology_cases_<split>.csv``: a header, the
cases in column ``"0"``) and the feature files (``*_features_<split>.csv``:
no header, one row per case). It inner-joins RNA with pathology on
``case``, then the patient info (``case, survival_months, vital_status``)
with that, and writes ``case, survival_months, vital_status,
feature_<i>_x`` (RNA) ``…, feature_<i>_y`` (pathology) ``…`` without an
index: the table ``feature_train`` reads (the ``feature_`` columns). The
reference's off-by-one rename is fixed, as in the JAX CLI. No device work.

    python -m multimodalbrainsurvival_torch.cli.concat_features \
        --rna_cases rna_cases_train.csv --rna_features rna_features_train.csv \
        --pathology_cases pathology_cases_train.csv \
        --pathology_features pathology_features_train.csv \
        --patientinfo train.csv --output features_train.csv
"""

from __future__ import annotations

import argparse

from multimodalbrainsurvival_torch.frames import inner_merge, n_rows, read_frame, write_frame

INFO_COLUMNS = ("case", "survival_months", "vital_status")


def _with_cases(features: str, cases: str) -> dict:
    frame = read_frame(features, header=False)
    case = read_frame(cases)["0"]
    if len(case) != n_rows(frame):
        raise ValueError(f"{cases} has {len(case)} cases but {features} has "
                         f"{n_rows(frame)} rows")
    frame["case"] = case
    return frame


def concat_features(
    rna_cases: str,
    rna_features: str,
    pathology_cases: str,
    pathology_features: str,
    patientinfo: str,
    output: str,
) -> dict:
    info = read_frame(patientinfo)
    info = {c: info[c] for c in INFO_COLUMNS}
    merged = inner_merge(_with_cases(rna_features, rna_cases),
                         _with_cases(pathology_features, pathology_cases), "case")
    final = inner_merge(info, merged, "case")
    names = list(INFO_COLUMNS) + [f"feature_{c}" for c in list(final)[3:]]
    final = dict(zip(names, final.values()))
    write_frame(output, final, index=False)
    return final


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rna_cases", default="extractfeatures/rna_cases.csv")
    p.add_argument("--rna_features", default="extractfeatures/rna_features.csv")
    p.add_argument("--pathology_cases", default="extractfeatures/pathology_cases.csv")
    p.add_argument("--pathology_features",
                   default="extractfeatures/pathology_features.csv")
    p.add_argument("--patientinfo", default="patientinfo.csv")
    p.add_argument("--output", default="features.csv")
    a = p.parse_args(argv)
    final = concat_features(a.rna_cases, a.rna_features, a.pathology_cases,
                            a.pathology_features, a.patientinfo, a.output)
    print((n_rows(final), len(final)))


if __name__ == "__main__":
    main()
