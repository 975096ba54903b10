"""The port's RNA CLIs against the JAX CLIs on one cohort and one set of
initial weights, on the CPU (``--device cpu``).

The cohort is the ``rna_experiment`` setup of ``tests/test_train.py``
(16 genes, the full 4,096 / 2,048 hidden widths, batches of 8 with a padded
last val/test batch), with ``dropout: 0``: the JAX package draws its
dropout masks with ``jax.random`` and the port hashes them in K2, so only
dropout-free runs can agree (``tests/test_golden_crossstack.py:13-16``
documents the same divergence against the reference). Both stacks start
from one seeded ``.pt``; the JAX side reads it through ``convert_checkpoint
--arch rna``. Frames are held at ``rtol=1e-4, atol=1e-5`` and the final
weights at 1e-5 absolute (they move by ~6e-5): float32 sums in another
order over 2 epochs of Adam.

The LR is 1e-5. Adam divides each gradient by √v + 1e-8, so an element
whose gradient is float32 noise steps by up to a few percent of the LR in a
direction the rounding picks, and the Cox loss leaves such elements: it is
blind to a constant added to every score, so the embedding layer's bias
gets a gradient of ~1e-10. At LR 1e-4 those steps reach the scores at
~1e-4, the size of the tolerance.

Both train runs pass ``--log 1``: the port's ``metrics.jsonl`` holds the
JAX CLI's (tag, step) sequence, its values at ``rtol=1e-4`` (the
throughput ``train/bags_per_s`` is a wall-clock rate and is not compared).

K2 at ``dropout > 0`` is held to its own contracts in
``tests/test_torch_dropout_matmul.py``; here a port-only run at
``dropout: 0.5`` shows that resuming from ``train_state.pt`` is exact.
"""

import contextlib
import io
import json
import re

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import (
    rna_extractfeatures,
    rna_savescore,
    rna_train,
)
from multimodalbrainsurvival_torch.cli.rna_train import build_rna_model
from tests.helpers import make_survival_csv
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

SPLITS = ("train", "val", "test")
N_GENES = 16
VARIANTS = {
    # plain Adam groups; early stopping ends the 4 epochs after epoch 1
    "plain_early_stop": {"num_epochs": 4, "early_stop_patience": 1,
                         "early_stop_min_delta": 10.0},
    "accumulate": {"accumulate_steps": 2},
    # the global norm is ≈4.4 at the start: clipped
    "schedule_clip": {"lr_schedule": "cosine", "warmup_steps": 2,
                      "grad_clip_norm": 2.0},
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rna_cohort")
    for split, n, seed in (("train", 24, 5), ("val", 12, 6), ("test", 12, 7)):
        make_survival_csv(str(tmp / f"rna_{split}.csv"),
                          [f"{split}{i}" for i in range(n)], n_rna=N_GENES, seed=seed)
    return tmp


def _config(cohort, out, **overrides):
    cfg = {
        "batch_size": 8, "num_workers": 1, "num_epochs": 2,
        "train_csv_path": str(cohort / "rna_train.csv"),
        "val_csv_path": str(cohort / "rna_val.csv"),
        "test_csv_path": str(cohort / "rna_test.csv"),
        "lr_rna": 1e-5, "lr_mlp": 1e-5, "weight_decay": 1e-5, "dropout": 0.0,
        "flag": "rna_model", "checkpoint_path": str(out) + "/",
        "restore_path": "", "model_path": "",
    }
    cfg.update(overrides)
    return cfg


def _write(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


def _random_state(seed):
    """Seeded numpy weights at the scale of torch's ``nn.Linear`` init.

    The head's weights are kept at least half the bound away from zero. The
    Cox loss is blind to a shift of the scores, so the gradient reaching
    embedding unit j is the head weight w_j times a sum that depends on j
    only through w_j; a w_j that Adam walks across zero would put all 4,096
    weights of unit j, for that step, where Adam's eps decides the update
    and float32 rounding in either stack shows up 100-fold in the features.
    """
    rng = np.random.default_rng(seed)
    model = build_rna_model(None, N_GENES)
    state = {}
    for name, linear in (("rna_mlp.1", model.rna_mlp[1]), ("rna_mlp.4", model.rna_mlp[4]),
                         ("final_mlp.0", model.final_mlp[0])):
        bound = 1.0 / np.sqrt(linear.in_features)
        for leaf in ("weight", "bias"):
            shape = getattr(linear, leaf).shape
            value = rng.uniform(-bound, bound, shape)
            if name == "final_mlp.0" and leaf == "weight":
                value = np.sign(value) * (bound + np.abs(value)) / 2
            state[f"{name}.{leaf}"] = torch.tensor(value, dtype=torch.float32)
    return state


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _best_epoch(log):
    return int(re.search(r"LOADING BEST MODEL, best epoch = (-?\d+)", log).group(1))


def _assert_scores_close(got, want):
    for col in ("survival_months", "vital_status"):
        np.testing.assert_array_equal(got[col], want[col])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def runs(request, cohort, tmp_path_factory):
    """train → savescore → extractfeatures through both stacks' CLI mains."""
    from multimodalbrainsurvival_tpu.cli import (
        rna_extractfeatures as jax_extract,
        rna_savescore as jax_savescore,
        rna_train as jax_train,
    )
    from multimodalbrainsurvival_tpu.cli.convert_checkpoint import convert

    tmp = tmp_path_factory.mktemp(f"rna_{request.param}")
    pt = tmp / "init.pt"
    torch.save(_random_state(seed=21), str(pt))
    flax_init = str(tmp / "init_flax")
    with contextlib.redirect_stdout(io.StringIO()):
        convert(str(pt), "rna", flax_init)

    result = {"variant": request.param}
    for name, train, save, extract, restore, last, extra in (
        ("jax", jax_train, jax_savescore, jax_extract, flax_init, "model_last", []),
        ("torch", rna_train, rna_savescore, rna_extractfeatures, str(pt),
         "model_last.pt", ["--device", "cpu"]),
    ):
        out = tmp / name
        # a log line every 2 steps: train/loss and train/bags_per_s are logged
        cfg = _config(cohort, out, restore_path=restore, log_interval=2,
                      **VARIANTS[request.param])
        log = _run(train.main, ["--config", _write(tmp / f"{name}_train.json", cfg),
                                "--log", "1"] + extra)
        serve = dict(cfg, model_path=str(out / "models/rna_model" / last),
                     output_path=str(out / "serve"))
        serve_cfg = _write(tmp / f"{name}_serve.json", serve)
        _run(save.main, ["--config", serve_cfg] + extra)
        _run(extract.main, ["--config", serve_cfg] + extra)
        result[name] = (out, log)
    return result


@pytest.mark.parametrize("tag", ["last", "best"])
@pytest.mark.parametrize("split", SPLITS)
def test_train_frames_match_jax(runs, split, tag):
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    name = f"outputs/rna_model/{split}_output_{tag}.csv"
    want, got = pd.read_csv(jax_out / name), pd.read_csv(torch_out / name)
    assert (torch_out / name).read_text().splitlines()[0] == \
        "id,score,survival_months,vital_status"
    assert list(got["id"]) == list(want["id"])
    assert np.isfinite(got["score"]).all()
    _assert_scores_close(got, want)


def test_best_epoch_and_last_weights_match_jax(runs):
    from multimodalbrainsurvival_tpu.models.convert import torch_rna_to_flax
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    (jax_out, jax_log), (torch_out, torch_log) = runs["jax"], runs["torch"]
    assert _best_epoch(torch_log) == _best_epoch(jax_log)
    save_dir = torch_out / "models/rna_model"
    assert {p.name for p in save_dir.iterdir()} >= {
        "model_last.pt", "model_dict_best.pt", "train_state.pt"}
    ours = torch_rna_to_flax({k: v.numpy() for k, v in torch.load(
        save_dir / "model_last.pt", weights_only=True).items()})["params"]
    theirs = Checkpointer().restore(str(jax_out / "models/rna_model/model_last"))["params"]
    for scope, dense in (("encoder", "dense_0"), ("encoder", "dense_1"), ("final", None)):
        a = ours[scope] if dense is None else ours[scope][dense]
        b = theirs[scope] if dense is None else theirs[scope][dense]
        for leaf in ("kernel", "bias"):
            assert np.max(np.abs(np.asarray(a[leaf]) - np.asarray(b[leaf]))) <= 1e-5
    start = torch.load(torch_out.parent / "init.pt", weights_only=True)
    last = torch.load(save_dir / "model_last.pt", weights_only=True)
    assert min(float((last[k] - v).abs().max()) for k, v in start.items()) > 3e-5


def _metrics(out):
    (path,) = (out / "summary").glob("*_rna_model/metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_log_writes_the_jax_metrics(runs):
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    want, got = _metrics(jax_out), _metrics(torch_out)
    assert [(r["tag"], r.get("step")) for r in got] == \
        [(r["tag"], r.get("step")) for r in want]
    assert got[0]["tag"] == "config" and "lr_rna" in got[0]["text"]
    assert {r["tag"] for r in got} >= {"train/loss", "train/bags_per_s", "val/loss",
                                       "val/case_CI", "test/case_CI"}
    for g, w in zip(got, want):
        if "value" in w and w["tag"] != "train/bags_per_s":
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-4,
                                       err_msg=f"{w['tag']} at step {w['step']}")


def test_early_stop_at_the_jax_epoch(runs):
    (_, jax_log), (_, torch_log) = runs["jax"], runs["torch"]
    stop = r"Early stopping at epoch (\d+)"
    assert re.findall(stop, torch_log) == re.findall(stop, jax_log)
    assert re.findall(stop, torch_log) == (["1"] if runs["variant"] == "plain_early_stop" else [])


@pytest.mark.parametrize("split", SPLITS)
def test_savescore_frames_match_jax(runs, split):
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    name = f"serve/rna_{split}_df.csv"
    want = pd.read_csv(jax_out / name, index_col=0)
    got = pd.read_csv(torch_out / name, index_col=0)
    assert list(got.columns) == ["id", "score", "survival_months", "vital_status"]
    assert list(got.index) == list(want.index) and list(got["id"]) == list(want["id"])
    _assert_scores_close(got, want)


@pytest.mark.parametrize("split", SPLITS)
def test_extractfeatures_frames_match_jax(runs, split):
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    cases = f"serve/rna_cases_{split}.csv"
    assert (torch_out / cases).read_bytes() == (jax_out / cases).read_bytes()
    want = np.loadtxt(jax_out / f"serve/rna_features_{split}.csv", delimiter=",")
    got = np.loadtxt(torch_out / f"serve/rna_features_{split}.csv", delimiter=",")
    assert got.shape == want.shape == (len(pd.read_csv(jax_out / cases)), 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_resume_at_dropout_is_exact(cohort, tmp_path):
    """One epoch, then a resumed second epoch, at ``dropout: 0.5``: the
    weights equal a straight two-epoch run's bit for bit (the dropout-seed
    generator, the optimizer moments and the best-loss bookkeeping are all
    in ``train_state.pt``)."""
    weights = {}
    for name, epochs in (("straight", [2]), ("resumed", [1, 2])):
        for n in epochs:
            cfg = _config(cohort, tmp_path / name, dropout=0.5, num_epochs=n,
                          resume=len(epochs) == 2 and n == 2)
            log = _run(rna_train.main,
                       ["--config", _write(tmp_path / f"{name}{n}.json", cfg),
                        "--device", "cpu"])
        assert ("Resumed full train state" in log) == (name == "resumed")
        weights[name] = torch.load(tmp_path / name / "models/rna_model/model_last.pt",
                                   weights_only=True)
    for k, v in weights["straight"].items():
        assert torch.equal(weights["resumed"][k], v), k


def test_emergency_checkpoint_is_reported_ignored(cohort, tmp_path, capsys):
    """``emergency_checkpoint`` is read now (the SIGTERM save,
    ``tests/test_torch_preemption.py``): it is no longer reported as
    ignored, and training no longer says that a SIGTERM loses the epoch's
    work; nor is ``preempt_sync_every``, the preemption consensus of a
    multi-rank run (``tests/test_torch_parallel_rna.py``)."""
    from multimodalbrainsurvival_torch.config import Config

    cfg = _config(cohort, tmp_path / "out", num_epochs=1, emergency_checkpoint=True,
                  preempt_sync_every=8)
    assert Config(cfg).ignored_keys() == []
    rna_train.main(["--config", _write(tmp_path / "cfg.json", cfg), "--device", "cpu"])
    out, err = capsys.readouterr()
    assert "ignoring keys with no meaning in the port" not in out
    assert "SIGTERM" not in err
    assert not (tmp_path / "out/models/rna_model/train_state.pt.preempt").exists()


def test_train_without_card_defaults_to_cuda_and_raises(cohort, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(tmp_path / "cfg.json", _config(cohort, tmp_path / "out"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        rna_train.main(["--config", path])


def test_unported_knobs_raise(cohort, tmp_path):
    """A multi-device ``mesh`` in a world of one process raises in training,
    naming the launcher (``parallel/mesh.py``). The serving CLIs never read
    ``mesh``, as the JAX ones do not: with ``quantize: "int8"`` under
    ``{"dp": 2}`` they serve on one device and write the frames of the
    config without the mesh (int8 parity with the JAX CLIs:
    ``tests/test_torch_rna_int8.py``)."""
    out = tmp_path / "out"
    path = _write(tmp_path / "cfg.json", _config(cohort, out, mesh={"dp": 2}))
    with pytest.raises(ValueError, match="torch.distributed.run"):
        rna_train.main(["--config", path, "--device", "cpu"])
    model = tmp_path / "model.pt"
    torch.save(build_rna_model(None, N_GENES).state_dict(), str(model))
    for name, mesh in (("mesh", {"dp": 2}), ("plain", {})):
        path = _write(tmp_path / f"serve_{name}.json", _config(
            cohort, out, quantize="int8", model_path=str(model),
            output_path=str(tmp_path / name), mesh=mesh))
        for main in (rna_savescore.main, rna_extractfeatures.main):
            main(["--config", path, "--device", "cpu"])
    written = sorted(p.name for p in (tmp_path / "plain").iterdir())
    assert written and written == sorted(p.name for p in (tmp_path / "mesh").iterdir())
    for name in written:
        assert (tmp_path / "mesh" / name).read_text() == (tmp_path / "plain" / name).read_text()
