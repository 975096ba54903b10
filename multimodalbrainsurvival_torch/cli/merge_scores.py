"""Merge unimodal risk-score frames for late fusion.

Parity with ``4_LateFusion/1_MergeScores.py`` and the JAX CLI
``multimodalbrainsurvival_tpu/cli/merge_scores.py:16-26``, without pandas:
the pathology frame's ``score`` becomes ``path_score`` and its ``id``
``case``, the RNA frame's ``score`` becomes ``rna_score``; the two are
inner-joined on ``case`` in the pathology frame's row order with
``rna_score`` appended, the ``Unnamed*`` columns (a written index) are
dropped, and the frame is written without an index: ``case, path_score,
survival_months, vital_status, rna_score``, the
``ExampleData/late_example.csv`` schema. No device work.

    python -m multimodalbrainsurvival_torch.cli.merge_scores \
        --pathology_scores ffpe_scores.csv --rna_scores rna_scores.csv \
        --output combined_scores.csv
"""

from __future__ import annotations

import argparse

from multimodalbrainsurvival_torch.frames import inner_merge, n_rows, read_frame, write_frame


def _rename(frame: dict, names: dict) -> dict:
    return {names.get(c, c): v for c, v in frame.items()}


def merge_scores(pathology_scores: str, rna_scores: str, output: str) -> dict:
    path_df = _rename(read_frame(pathology_scores), {"score": "path_score", "id": "case"})
    rna_df = _rename(read_frame(rna_scores), {"score": "rna_score", "id": "case"})
    final = inner_merge(path_df, {"case": rna_df["case"], "rna_score": rna_df["rna_score"]},
                        "case")
    final = {c: v for c, v in final.items() if not str(c).startswith("Unnamed")}
    write_frame(output, final, index=False)
    return final


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pathology_scores", default="savescore/ffpe_scores.csv")
    p.add_argument("--rna_scores", default="savescore/rna_scores.csv")
    p.add_argument("--output", default="combined_scores.csv")
    a = p.parse_args(argv)
    final = merge_scores(a.pathology_scores, a.rna_scores, a.output)
    print((n_rows(final), len(final)))


if __name__ == "__main__":
    main()
