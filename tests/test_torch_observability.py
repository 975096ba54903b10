"""The trace and step-checking keys of the port's train CLIs, on the CPU:
the cases of ``tests/test_observability.py`` for ``profile_steps``,
``profile_dir`` and ``debug_checkify``.

``profile_steps: 3`` writes a ``torch.profiler`` trace of three train steps
under ``<save_dir>/torch_trace``; ``profile_dir`` moves it, and a run
shorter than the warmup and the trace still writes one. ``debug_checkify``
lets a healthy run finish and names a NaN planted in the inputs. None of
the three keys is reported as ignored any more.
"""

import csv
import json
import os

import pytest
import torch

from multimodalbrainsurvival_torch.cli import feature_train, histo_train
from multimodalbrainsurvival_torch.config import Config
from tests.helpers import make_survival_csv
from tests.test_torch_histo_train import _config, _write, cohort, few_threads  # noqa: F401
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

KEYS = ("profile_steps", "profile_dir", "debug_checkify")


def _write_config(tmp_path, extra: dict) -> str:
    for split, n, seed in (("train", 12, 1), ("val", 6, 2), ("test", 6, 3)):
        make_survival_csv(str(tmp_path / f"{split}.csv"),
                          [f"{split[0]}{i}" for i in range(n)], n_feature=8, seed=seed)
    cfg = {
        "batch_size": 4, "train_csv_path": str(tmp_path / "train.csv"),
        "val_csv_path": str(tmp_path / "val.csv"),
        "test_csv_path": str(tmp_path / "test.csv"),
        "num_epochs": 3, "lr": 1e-4, "weight_decay": 0.0, "flag": "obs",
        "checkpoint_path": str(tmp_path / "out") + "/", "restore_path": "",
    }
    cfg.update(extra)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _traces(trace_dir):
    return [os.path.join(r, f) for r, _, fs in os.walk(trace_dir) for f in fs
            if f.endswith(".pt.trace.json")]


def test_cli_profile_steps_writes_trace(tmp_path, capsys):
    """3 epochs of 3 steps: the trace starts after the 5-step warmup and
    holds steps 5-8."""
    feature_train.main(["--config", _write_config(tmp_path, {"profile_steps": 3}),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    trace_dir = str(tmp_path / "out/models/obs/torch_trace")
    assert out.count(f"wrote profiler trace to {trace_dir}") == 1
    traces = _traces(trace_dir)
    assert [os.path.basename(t) for t in traces] == ["train_steps_5-8.pt.trace.json"]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert "ignoring" not in out


def test_cli_profile_dir_override_and_short_run(tmp_path, capsys):
    """An explicit ``profile_dir`` wins, and a run of 3 steps (shorter than
    the 5-step warmup and the trace) still writes one: the warmup shrinks
    to 1 step."""
    trace_dir = str(tmp_path / "trace_here")
    cfg = _write_config(tmp_path, {"profile_steps": 2, "profile_dir": trace_dir,
                                   "num_epochs": 1})
    feature_train.main(["--config", cfg, "--device", "cpu"])
    assert f"wrote profiler trace to {trace_dir}" in capsys.readouterr().out
    assert [os.path.basename(t) for t in _traces(trace_dir)] == [
        "train_steps_1-3.pt.trace.json"]


def test_cli_profile_a_trace_cut_short_by_the_run_is_written(tmp_path, capsys):
    """``profile_steps`` longer than the whole run: the trace starts at
    once and is written when the run ends."""
    cfg = _write_config(tmp_path, {"profile_steps": 10, "num_epochs": 1})
    feature_train.main(["--config", cfg, "--device", "cpu"])
    assert "wrote profiler trace to" in capsys.readouterr().out
    assert [os.path.basename(t) for t in _traces(tmp_path / "out/models/obs/torch_trace")] \
        == ["train_steps_0-3.pt.trace.json"]


def test_histo_train_profile_steps_writes_trace(cohort, tmp_path, capsys,
                                                few_threads):  # noqa: F811
    cfg = _config(cohort, tmp_path / "h", num_epochs=1, profile_steps=2)
    histo_train.main(["--config", _write(tmp_path / "h.json", cfg), "--device", "cpu"])
    trace_dir = tmp_path / "h/models/histo_model/torch_trace"
    assert f"wrote profiler trace to {trace_dir}" in capsys.readouterr().out
    assert len(_traces(trace_dir)) == 1


def test_cli_debug_checkify_run_clean(tmp_path, capsys):
    feature_train.main(["--config", _write_config(tmp_path, {"debug_checkify": True,
                                                             "num_epochs": 1}),
                        "--device", "cpu"])
    assert "ignoring" not in capsys.readouterr().out
    assert (tmp_path / "out/outputs/obs/val_output_best.csv").is_file()


def test_cli_debug_checkify_names_a_nan(tmp_path):
    """A NaN planted in the train data makes the checked run fail with an
    error that names it (feature_train's evaluation before the first epoch
    meets it first, as the JAX CLI's test allows)."""
    cfg = _write_config(tmp_path, {"debug_checkify": True, "num_epochs": 1})
    train_csv = tmp_path / "train.csv"
    with open(train_csv, newline="") as f:
        rows = list(csv.reader(f))
    rows[1][rows[0].index("feature_0")] = "nan"
    with open(train_csv, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)
    with pytest.raises(FloatingPointError, match="nan"):
        feature_train.main(["--config", cfg, "--device", "cpu"])


class _Adapter:
    sample_mask_key = "mask"

    def __init__(self):
        self.w = torch.zeros(3, requires_grad=True)

    def apply(self, arrays, train=False, generator=None):
        return torch.sqrt(arrays["x"] * self.w)[:, None]


class _Optimizer:
    def __init__(self, params):
        self.params = params

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_debug_checkify_names_the_nan_of_a_step(where):
    """A step whose forward makes the loss NaN raises naming it before the
    backward; one whose loss is finite but whose backward makes a NaN
    raises from anomaly mode, naming the backward function."""
    from multimodalbrainsurvival_torch.train.loop import TrainSettings, train_step

    adapter = _Adapter()
    x = [0.0, 1.0, float("nan") if where == "forward" else 2.0]
    arrays = {"x": torch.tensor(x), "mask": torch.ones(3, dtype=torch.bool)}

    def loss_fn(out, a, m):
        return out.sum() if where == "forward" else (out * 0).sum()

    settings = TrainSettings(batch_size=3, debug_checkify=True)
    match = ("debug_checkify: the forward made the loss nan" if where == "forward"
             else "SqrtBackward0.*nan")
    with pytest.raises((FloatingPointError, RuntimeError), match=match):
        train_step(adapter, _Optimizer([adapter.w]), loss_fn, arrays, settings,
                   torch.Generator())
    # without the key the same step runs through
    train_step(adapter, _Optimizer([adapter.w]), loss_fn, arrays,
               TrainSettings(batch_size=3), torch.Generator())


def test_the_keys_are_not_reported_ignored():
    cfg = Config({k: v for k, v in zip(KEYS, (3, "d", True))} | {"donate_state": False})
    assert cfg.ignored_keys() == ["donate_state"]
    assert cfg.unknown_keys() == []
