"""The joint CLIs against the JAX CLIs where rounding sets how far they may
part: the bf16 joint path, and the two-bags-per-slide cohort, whose float32
training amplifies rounding.

Both cases start from ``tests/test_torch_joint.py``'s ``experiment`` (its
cohort, config and seeded initial model) on the CPU.

**bf16** (``compute_dtype: "bfloat16"``, the joint path the card trains):
``joint_train`` → ``joint_savescore`` through both stacks. The RNA encoder
runs K2a's and K2b's bf16 forms (their plain versions here). The two stacks
round the ResNet to bf16 at different points. The port runs it under
autocast: BatchNorm, the residual adds and the pool in float32, the
convolutions' outputs in bf16. The flax ResNet materialises each
normalised activation and residual sum in bf16. So each stack's bf16
scores lie up to 0.9-3.6% of their scale from its own float32 scores. The
two bf16 runs lie 0.63% (train and val) and 0.9% (test) apart, and their
losses 1.07%. Both are held within 2**-6 of the scale (relative for the
losses): four units of bf16 rounding (2**-8). The bf16 backward is held by
its direction: 99% of the elements of each RNA-encoder and head weight
moved the way the JAX package's did (99.7-99.99% here). A wrong dx or dW
would show as a coin flip (50%) or as no move.

**Two bags per slide** (the fixture's ``train_bag_size: 2``), float32. Two
bags of a slide share one RNA vector and one survival time. Here the port
run against itself, started from the same weights each moved by one
float32 ulp, parts by 6.6e-5 in score (scale 1.9). That is as far as it
parts from the JAX run (6.3e-5), beyond ``rtol=1e-4`` on a score of 0.15.
With one bag per slide, the same nudge parts the port's runs by 9.5e-7. So
the gap is float32 rounding that this cohort amplifies, not a fault: each
split's scores may part from the JAX package's by at most twice what the
nudge moves them, and the nudge moves the one-bag scores by under a tenth
of that. Losses, the best epoch and the weights (Adam's ceiling,
``assert_within_adam_ceiling``) are held as on the one-bag cohort.
"""

import pathlib
import re
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import joint_savescore, joint_train
from tests.test_torch_joint import (  # noqa: F401  (module fixtures)
    SPLITS,
    STACKS,
    TOL,
    _losses,
    _run,
    _write,
    assert_within_adam_ceiling,
    experiment,
    few_threads,
    trained_group,
    trained_weights,
)
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

#: bf16 scores and losses: four units of bf16 rounding, 4 · 2**-8
BF16_TOL = 2**-6
BEST = r"LOADING BEST MODEL, best epoch = (-?\d+)"


def _mains(stack: str) -> tuple:
    """The ``joint_train`` and ``joint_savescore`` mains of a stack."""
    if stack == "torch":
        return joint_train.main, joint_savescore.main
    from multimodalbrainsurvival_tpu.cli import joint_savescore as serve, joint_train as train

    return train.main, serve.main


def _train(tmp, name: str, stack: str, cfg: dict) -> str:
    """``joint_train`` of one stack; its log. Only ``model_last`` is kept of
    the checkpoints (the train state and the best model are 4/5 of the
    run's disk, and no test here reads them)."""
    argv = ["--config", _write(tmp / f"{name}.json", cfg)] + STACKS[stack][0]
    log = _run(_mains(stack)[0], argv)
    for path in (pathlib.Path(cfg["checkpoint_path"]) / "models/joint_model").iterdir():
        if not path.name.startswith("model_last"):
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    return log


def _frame(path) -> np.ndarray:
    return pd.read_csv(path)["score"].to_numpy()


# --- bf16 -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_runs(experiment):
    """Both stacks' ``joint_train`` (2 epochs) in bf16, then ``joint_savescore``
    on the trained model."""
    tmp, cfg, _, init = experiment
    result = {}
    for name, (extra, last) in STACKS.items():
        out = tmp / f"bf16_{name}"
        c = dict(cfg, compute_dtype="bfloat16", checkpoint_path=str(out) + "/",
                 restore_path=init[name])
        log = _train(tmp, f"bf16_{name}_train", name, c)
        s = dict(c, restore_path="", output_path=str(out / "serve"),
                 model_path=str(out / "models/joint_model" / last))
        log += _run(_mains(name)[1],
                    ["--config", _write(tmp / f"bf16_{name}_s.json", s)] + extra)
        result[name] = (out, log)
    return result


@pytest.mark.parametrize("tag", ["EPOCH", "TRAIN", "VAL"])
def test_bf16_joint_losses_match_jax(bf16_runs, tag):
    want, got = _losses(bf16_runs["jax"][1], tag), _losses(bf16_runs["torch"][1], tag)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=0)


def test_bf16_joint_best_epoch_matches_jax(bf16_runs):
    assert re.findall(BEST, bf16_runs["torch"][1]) == re.findall(BEST, bf16_runs["jax"][1])


@pytest.mark.parametrize("frame", ["last", "best", "savescore"])
@pytest.mark.parametrize("split", SPLITS)
def test_bf16_joint_frames_match_jax(bf16_runs, split, frame):
    """``<split>_output_{last,best}.csv`` of ``joint_train`` and the case-level
    ``joint_savescore`` frame, within ``BF16_TOL`` of the scale."""
    (jax_out, _), (torch_out, _) = bf16_runs["jax"], bf16_runs["torch"]
    if frame == "savescore":
        (want_path,) = (jax_out / "serve").glob(f"*_joint_{split}_df.csv")
        got_path = torch_out / "serve" / f"model_last.pt_joint_{split}_df.csv"
    else:
        want_path = got_path = f"outputs/joint_model/{split}_output_{frame}.csv"
        want_path, got_path = jax_out / want_path, torch_out / got_path
    want, got = _frame(want_path), _frame(got_path)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_bf16_joint_weights_step_as_jax(experiment, bf16_runs):
    """Each RNA-encoder and head weight moved, in 99% of its elements, the
    way the JAX package's did (its bf16 gradient has the JAX sign there);
    the frozen weights are unchanged in both."""
    _, cfg, init, _ = experiment
    ours, theirs = trained_weights({name: out for name, (out, _) in bf16_runs.items()})
    for k in ("rna_mlp.1.weight", "rna_mlp.4.weight", "final_mlp.1.weight"):
        ours_step, theirs_step = ours[k] - init[k], theirs[k] - init[k]
        assert ours_step.abs().max().item() > cfg["lr_rna"] / 2, k
        same = (ours_step.sign() == theirs_step.sign()).float().mean().item()
        assert same >= 0.99, (k, same)
    for k, v in ours.items():
        if trained_group(cfg, k) is None and not k.endswith(
                ("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(v, init[k]) and torch.equal(theirs[k], init[k]), k


# --- two bags per slide ------------------------------------------------------------


@pytest.fixture(scope="module")
def two_bag_runs(experiment):
    """``joint_train`` at bags of 2 through both stacks, and through the port
    again from the initial weights each moved by one float32 ulp (a random
    direction per element, seeded); the port from both starts at one bag
    of 4 per slide too."""
    tmp, cfg, state, init = experiment
    g = torch.Generator().manual_seed(0)
    nudged = {k: torch.nextafter(v, v + torch.where(
                  torch.rand(v.shape, generator=g) < 0.5, -1.0, 1.0))
              if v.is_floating_point() else v for k, v in state.items()}
    torch.save(nudged, str(tmp / "nudged.pt"))
    two_bags = dict(cfg, train_bag_size=2, val_bag_size=2)
    result = {}
    for name, stack, start, c in (
            ("jax", "jax", init["jax"], two_bags),
            ("torch", "torch", init["torch"], two_bags),
            ("nudged", "torch", str(tmp / "nudged.pt"), two_bags),
            ("one_bag", "torch", init["torch"], cfg),
            ("one_bag_nudged", "torch", str(tmp / "nudged.pt"), cfg)):
        out = tmp / f"two_bag_{name}"
        c = dict(c, checkpoint_path=str(out) + "/", restore_path=start)
        result[name] = (out, _train(tmp, f"two_bag_{name}", stack, c))
    return two_bags, result


@pytest.mark.parametrize("tag", ["EPOCH", "TRAIN", "VAL"])
def test_two_bag_joint_losses_match_jax(two_bag_runs, tag):
    _, runs = two_bag_runs
    want, got = _losses(runs["jax"][1], tag), _losses(runs["torch"][1], tag)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **TOL)


def test_two_bag_joint_best_epoch_and_weights_match_jax(experiment, two_bag_runs):
    """The best epoch; the weights within Adam's ceiling after two batches
    of 4 bags an epoch."""
    _, _, init, _ = experiment
    cfg, runs = two_bag_runs
    assert re.findall(BEST, runs["torch"][1]) == re.findall(BEST, runs["jax"][1])
    ours, theirs = trained_weights({name: runs[name][0] for name in ("jax", "torch")})
    assert_within_adam_ceiling(ours, theirs, init, cfg, steps=4)


@pytest.mark.parametrize("split", SPLITS)
def test_two_bag_score_gap_is_float32_noise(two_bag_runs, split):
    """The port's scores lie no further from the JAX package's than twice
    the distance one ulp of the initial weights moves them, and this cohort
    is what amplifies the ulp: with one bag per slide it moves the scores
    by less than a tenth as much, within ``TOL``'s ``atol``."""
    _, runs = two_bag_runs
    name = f"outputs/joint_model/{split}_output_last.csv"
    score = {k: _frame(out / name) for k, (out, _) in runs.items()}
    noise = np.abs(score["nudged"] - score["torch"]).max()
    gap = np.abs(score["torch"] - score["jax"]).max()
    calm = np.abs(score["one_bag_nudged"] - score["one_bag"]).max()
    assert 0 < gap <= 2 * noise, (gap, noise)
    assert calm <= min(noise / 10, TOL["atol"]), (calm, noise)
