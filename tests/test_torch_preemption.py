"""Preemption and mid-epoch resume of the port's train loop, on the CPU.

A run preempted mid-epoch and resumed with ``resume: true`` ends bit for
bit where an uninterrupted run ends: the same ``model_last.pt``, the same
frames, the same printed loss trace (every windowed train loss, each
epoch's loss over all its batches, the eval losses). The preemption comes
from ``preempt_after_steps``, set through the CLI's ``TrainSettings``, so
the CLI's ``run_train`` turns it into exit status 143. Cases: the RNA table
pipeline at dropout 0.5, the MIL patch pipeline with the flips and colour
jitter on (whose resume replays the dataset's in-slide shuffles up to the
interrupted epoch's), and a preemption at an epoch's last batch. Then a
real SIGTERM to a CLI process, after its first ``bags/s`` line: it exits
143, leaves ``train_state.pt.preempt``, and a rerun with ``resume: true``
takes it up and deletes it at the end.
"""

import contextlib
import functools
import io
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from multimodalbrainsurvival_torch.cli import histo_train, rna_train
from multimodalbrainsurvival_torch.cli._common import PREEMPTED_EXIT_CODE
from multimodalbrainsurvival_torch.train import TrainSettings
from tests import test_torch_histo_train as histo
from tests import test_torch_rna_cli as rna
from tests.test_torch_histo_train import cohort, few_threads  # noqa: F401
from tests.test_torch_rna_cli import cohort as rna_cohort  # noqa: F401
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# the SIGTERM test's limit, its two processes together
SIGTERM_TEST_S = 120


# name → (CLI module, the config's overrides, preempt at global step,
# expected (epoch, batch) of the saved state)
CASES = {
    # 24 rows in batches of 8: 3 steps an epoch; step 4 is epoch 1's first
    "rna_dropout": (rna_train, dict(dropout=0.5, num_epochs=3, lr_rna=1e-3,
                                    lr_mlp=1e-3, log_interval=2), 4, (1, 1)),
    # 15 bags of 2 in batches of 3: 5 steps an epoch; step 7 is epoch 1's second
    "mil_augment": (histo_train, dict(augment=True, lr=1e-3, n_layers_to_train=6),
                    7, (1, 2)),
    "mil_last_batch": (histo_train, dict(augment=True, lr=1e-3), 5, (0, 5)),
}


def _cfg(name, cohort, rna_cohort, out, **extra):
    module, overrides, _, _ = CASES[name]
    if module is rna_train:
        return rna._config(rna_cohort, out, **overrides, **extra)
    return histo._config(cohort, out, **overrides, **extra)


def _trace(log: str) -> list[str]:
    """The printed loss trace without the wall-clock throughput."""
    lines = re.findall(r"^(train \| epoch \d+ \| step \d+ \| loss +\S+) \||$"
                       r"|^((?:EPOCH|TRAIN|VAL) Loss: \S+)$", log, re.M)
    return [a or b for a, b in lines if a or b]


def _run_cli(module, path, monkeypatch=None, preempt_at=0):
    """(stdout, exit status) of the CLI's ``main``, preempted at global step
    ``preempt_at`` (0: never)."""
    if preempt_at:
        monkeypatch.setattr(module, "TrainSettings",
                            functools.partial(TrainSettings, preempt_after_steps=preempt_at))
    out, code = io.StringIO(), 0
    try:
        with contextlib.redirect_stdout(out):
            module.main(["--config", path, "--device", "cpu"])
    except SystemExit as e:
        code = e.code
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()
    return out.getvalue(), code


@pytest.mark.parametrize("name", list(CASES))
def test_preempted_run_resumes_exactly(name, cohort, rna_cohort, tmp_path,  # noqa: F811
                                       monkeypatch):
    module, _, preempt_at, (epoch, batch) = CASES[name]
    flag = "rna_model" if module is rna_train else "histo_model"

    straight = tmp_path / "straight"
    log, code = _run_cli(module, histo._write(tmp_path / "straight.json",
                                              _cfg(name, cohort, rna_cohort, straight)))
    assert code == 0

    parted = tmp_path / "parted"
    path = histo._write(tmp_path / "parted.json", _cfg(name, cohort, rna_cohort, parted))
    threads = set(threading.enumerate())
    first, code = _run_cli(module, path, monkeypatch, preempt_at)
    assert code == PREEMPTED_EXIT_CODE
    # the loader's producer thread was stopped and joined
    assert set(threading.enumerate()) <= threads
    save = parted / "models" / flag
    state = torch.load(save / "train_state.pt.preempt", weights_only=True)
    assert (state["meta"]["epoch"], state["meta"]["epoch_step"]) == (epoch, batch)
    assert state["meta"]["step"] == preempt_at
    assert f"PREEMPTED: saved full train state (epoch {epoch}, batch {batch}" in first

    resumed = histo._write(tmp_path / "resumed.json",
                           _cfg(name, cohort, rna_cohort, parted, resume=True))
    second, code = _run_cli(module, resumed)
    assert code == 0
    assert f"train_state.pt.preempt: epoch {epoch} (batch {batch})" in second
    assert not (save / "train_state.pt.preempt").exists()

    assert _trace(first) + _trace(second) == _trace(log)
    want = torch.load(straight / "models" / flag / "model_last.pt", weights_only=True)
    got = torch.load(save / "model_last.pt", weights_only=True)
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    outputs = sorted(p.name for p in (straight / "outputs" / flag).iterdir())
    assert len(outputs) == 6
    for frame in outputs:
        assert (parted / "outputs" / flag / frame).read_bytes() == \
            (straight / "outputs" / flag / frame).read_bytes(), frame


def test_resume_takes_the_newer_state(cohort, tmp_path, monkeypatch):  # noqa: F811
    """A ``.preempt`` older than ``train_state.pt`` (a later boundary save)
    is not the one resumed from."""
    out = tmp_path / "out"
    path = histo._write(tmp_path / "cfg.json", histo._config(cohort, out, num_epochs=1))
    _, code = _run_cli(histo_train, path, monkeypatch, 2)
    assert code == PREEMPTED_EXIT_CODE
    save = out / "models/histo_model"
    torch.save(torch.load(save / "train_state.pt.preempt", weights_only=True),
               save / "train_state.pt")
    old = save / "train_state.pt.preempt"
    os.utime(old, (1, 1))
    log, code = _run_cli(histo_train, histo._write(
        tmp_path / "resume.json", histo._config(cohort, out, num_epochs=1, resume=True)))
    assert code == 0
    assert "Resumed full train state from " + str(save / "train_state.pt:") in log


def test_no_handler_without_save_or_when_turned_off(cohort, tmp_path, monkeypatch):  # noqa: F811
    """``emergency_checkpoint: false`` installs no handler and ignores
    ``preempt_after_steps``; after a run the previous SIGTERM handler is
    back."""
    seen = []

    def handler(signum, frame):
        seen.append(signum)

    previous = signal.signal(signal.SIGTERM, handler)
    try:
        out = tmp_path / "out"
        cfg = histo._config(cohort, out, num_epochs=1, emergency_checkpoint=False)
        log, code = _run_cli(histo_train, histo._write(tmp_path / "cfg.json", cfg),
                             monkeypatch, 1)
        assert code == 0 and "PREEMPTED" not in log
        assert signal.getsignal(signal.SIGTERM) is handler
        cfg = histo._config(cohort, tmp_path / "on", num_epochs=1)
        _, code = _run_cli(histo_train, histo._write(tmp_path / "on.json", cfg))
        assert code == 0 and signal.getsignal(signal.SIGTERM) is handler
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert not seen


# the CLI in a process of its own, each train step held for 0.3 s so that a
# SIGTERM sent after the first log line lands mid-training
_SLOW_CLI = """
import sys, time
from multimodalbrainsurvival_torch.train import loop
step = loop.train_step
def held(*args, **kwargs):
    out = step(*args, **kwargs)
    time.sleep(0.3)
    return out
loop.train_step = held
from multimodalbrainsurvival_torch.cli import rna_train
rna_train.main(sys.argv[1:])
"""


def test_sigterm_through_the_cli_exits_143_and_resumes(rna_cohort, tmp_path):  # noqa: F811
    out = tmp_path / "out"
    cfg = rna._config(rna_cohort, out, num_epochs=3, dropout=0.5, log_interval=1)
    path = histo._write(tmp_path / "cfg.json", cfg)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SLOW_CLI, "--config", path, "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # the whole test stays within SIGTERM_TEST_S, whatever the processes do
    watchdog = threading.Timer(SIGTERM_TEST_S / 2, proc.kill)
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "bags/s" in line:
                proc.send_signal(signal.SIGTERM)
                break
        lines.extend(proc.stdout)
        code = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = "".join(lines)
    assert code == PREEMPTED_EXIT_CODE, log
    assert "preemption signal received" in log and "exiting after preemption" in log
    save = out / "models/rna_model"
    assert (save / "train_state.pt.preempt").exists()
    assert not (save / "model_last.pt").exists()

    cfg["resume"] = True
    done = subprocess.run(
        [sys.executable, "-m", "multimodalbrainsurvival_torch.cli.rna_train",
         "--config", histo._write(tmp_path / "resume.json", cfg), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=SIGTERM_TEST_S / 2)
    assert done.returncode == 0, done.stdout + done.stderr
    assert re.search(r"Resumed full train state from \S+train_state\.pt\.preempt: "
                     r"epoch \d+ \(batch \d+\)", done.stdout), done.stdout
    assert not (save / "train_state.pt.preempt").exists()
    assert (save / "model_last.pt").exists()
