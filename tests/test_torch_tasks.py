"""The port's ``survival_bin`` and ``classification`` tasks against the JAX
package, on the CPU.

- ``nll_surv_loss`` over masks, ``alpha`` and the three reductions
  (``rtol=1e-6``), and from a bfloat16 head;
- the classification loss (masked mean of softmax cross-entropy) against
  the JAX loss, which is optax's, and both tasks' gradients;
- ``classification_scores`` (two classes with tied scores, three classes)
  and ``nllsurv_ci`` against the JAX ones, which group with pandas and
  score with sklearn, at 1e-12. The outputs are float64: pandas keeps a
  float32 column's group mean in float32, the port's is float64;
- ``histo_train`` then ``histo_savescore`` and ``histo_extractfeatures``,
  the port's CLIs against the JAX CLIs, for both tasks with the ``attention`` and the ``transformer``
  aggregator, at ``augment: false`` and LR 1e-5 from one seeded ``.pt``
  (as ``tests/test_torch_histo_train.py``, whose cohort and tolerances
  this reuses: losses and frames at ``rtol=1e-4, atol=1e-5``). The
  transformer runs with its dropout set to 0 in both stacks' factories:
  torch cannot draw ``jax.random``'s numbers, so the two stacks' dropout
  masks differ (its train-mode dropout is held to flax's semantics in
  ``tests/test_torch_transformer.py``).
"""

import contextlib
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalbrainsurvival_torch.cli import (
    _common,
    histo_extractfeatures,
    histo_savescore,
    histo_train,
)
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.kernels import attention_pool as k1
from multimodalbrainsurvival_torch.models.aggregators import make_aggregator
from multimodalbrainsurvival_torch.ops import metrics as M
from multimodalbrainsurvival_torch.ops.nll_surv import nll_surv_loss
from multimodalbrainsurvival_torch.train.loop import TrainSettings, make_loss_fn
from multimodalbrainsurvival_tpu.ops import metrics as jax_metrics
from multimodalbrainsurvival_tpu.ops.nll_surv import nll_surv_loss as jax_nll
from tests.test_torch_histo_cli import _random_state
from tests.test_torch_histo_train import SPLITS, _config, _run, _write
from tests.test_torch_histo_train import cohort as _survival_cohort  # noqa: F401
from tests.test_torch_transformer import torch_transformer_to_flax
from tests._torch_tmp import remove_module_tmp, remove_tmp_path  # noqa: F401

K = 4  # bins / classes of the loss tests


def _nll_inputs(case, n=10, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(0.0, 2.0, (n, K)).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.int32)
    c = rng.integers(0, 2, n).astype(np.float32)
    mask = {"none": None, "partial": np.arange(n) < n - 3,
            "all_masked": np.zeros(n, bool)}[case]
    if mask is not None:
        h[~mask] = 40.0  # pads must add nothing, whatever their logits
    return h, y, c, mask


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("alpha", [0.0, 0.4])
@pytest.mark.parametrize("case", ["none", "partial", "all_masked"])
def test_nll_surv_loss_matches_jax(case, alpha, reduction):
    h, y, c, m = _nll_inputs(case)
    want = np.asarray(jax_nll(jnp.asarray(h), jnp.asarray(y), jnp.asarray(c),
                              None if m is None else jnp.asarray(m),
                              alpha=alpha, reduction=reduction))
    got = nll_surv_loss(torch.from_numpy(h), torch.from_numpy(y), torch.from_numpy(c),
                        None if m is None else torch.from_numpy(m),
                        alpha=alpha, reduction=reduction)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_nll_surv_loss_computes_in_float32_from_a_bfloat16_head():
    h, y, c, m = _nll_inputs("partial", seed=1)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    want = float(jax_nll(jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16),
                         jnp.asarray(y), jnp.asarray(c), jnp.asarray(m)))
    got = nll_surv_loss(hb, torch.from_numpy(y), torch.from_numpy(c), torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def _task_batch(task, seed=0, n=9):
    rng = np.random.default_rng(seed)
    out = rng.normal(0.0, 2.0, (n, K)).astype(np.float32)
    arrays = {
        "survival_bin": rng.integers(0, K, n).astype(np.int32),
        "vital_status": rng.integers(0, 2, n).astype(np.float32),
        "label": rng.integers(0, K, n).astype(np.int32),
    }
    mask = np.arange(n) < n - 2
    return out, arrays, mask


@pytest.mark.parametrize("task", ["classification", "survival_bin"])
def test_task_losses_and_gradients_match_jax(task):
    """The task's loss through both stacks' ``make_loss_fn`` (the JAX
    classification loss is ``optax.softmax_cross_entropy_with_integer_
    labels``), and its gradient against ``jax.grad``."""
    from multimodalbrainsurvival_tpu.train import loop as jax_loop

    out, arrays, mask = _task_batch(task)
    kw = dict(task=task, num_classes=K, target_label="label")
    jax_fn, jax_keys = jax_loop.make_loss_fn(jax_loop.TrainSettings(**kw))
    fn, keys = make_loss_fn(TrainSettings(**kw))
    assert keys == jax_keys
    j_arrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    want, want_grad = jax.value_and_grad(lambda o: jax_fn(o, j_arrays, jnp.asarray(mask)))(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    got = fn(o, {k: torch.from_numpy(v) for k, v in arrays.items()}, torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    assert not o.grad[~torch.from_numpy(mask)].any()


def _scores(n_class, seed=0, n=60, cases=17):
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(n, n_class))
    ids = [f"c{i % cases:02d}" for i in range(n)]
    if n_class == 2:
        # tied mean scores across ids: the AUC's average ranks
        for i in range(n):
            out[i] = out[i % 3]
    labels_by_id = rng.integers(0, n_class, cases)
    labels_by_id[:n_class] = np.arange(n_class)
    labels = np.array([labels_by_id[int(i[1:])] for i in ids])
    return out, ids, labels


def _frame_equal(got: dict, want: pd.DataFrame, rtol=1e-12):
    assert list(got) == list(want.columns)
    for col in want.columns:
        if want[col].dtype.kind in "fc":
            np.testing.assert_allclose(got[col], want[col].to_numpy(), rtol=rtol,
                                       atol=rtol, err_msg=col)
        else:
            assert list(got[col]) == list(want[col]), col


@pytest.mark.parametrize("n_class", [2, 3])
def test_classification_scores_match_jax(n_class):
    out, ids, labels = _scores(n_class)
    want = jax_metrics.classification_scores(out, ids, labels)
    got = M.classification_scores(out, ids, labels)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-12, atol=1e-12)
    _frame_equal(got[3], want[3])


def test_roc_auc_refuses_one_class():
    with pytest.raises(ValueError, match="Only one class"):
        M.roc_auc(np.ones(4), np.arange(4.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_nllsurv_ci_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, cases = 50, 14
    out = rng.normal(size=(n, K + 1))  # a wider head: only num_classes columns count
    ids = [f"c{i % cases:02d}" for i in range(n)]
    status = np.array([(int(i[1:]) * 7 + seed) % 2 for i in ids])
    months = np.array([float(int(i[1:]) % 5 + 1) for i in ids])  # tied times
    want = jax_metrics.nllsurv_ci(out, status, months, ids, K)
    got = M.nllsurv_ci(out, status, months, ids, K)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert max(got[1]["score"]) <= 0.0
    _frame_equal(got[1], want[1])


# the CLI runs: (task, num_classes, target_label) x aggregator
TASKS = {"classification": (2, "label"), "survival_bin": (K, "vital_status")}
AGGREGATORS = ("attention", "transformer")


@pytest.fixture(scope="module")
def cohort(_survival_cohort):  # noqa: F811
    """The histo train cohort with a ``label`` and a ``survival_bin``
    column, each split holding both classes."""
    for i, split in enumerate(SPLITS):
        path = _survival_cohort / f"{split}.csv"
        df = pd.read_csv(path)
        df["label"] = (np.arange(len(df)) + i) % 2
        df["survival_bin"] = (np.arange(len(df)) * 3 + i) % K
        df.to_csv(path, index=False)
    return _survival_cohort


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _transformer_without_dropout():
    """Both stacks' CLIs build the transformer with dropout 0."""
    from multimodalbrainsurvival_tpu.cli import histo_train as jax_train

    mp = pytest.MonkeyPatch()
    for module, factory in ((jax_train, jax_train.make_aggregator),
                            (_common, make_aggregator)):
        mp.setattr(module, "make_aggregator", functools.partial(factory, dropout=0.0))
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module",
                params=[(t, a) for t in TASKS for a in AGGREGATORS],
                ids=[f"{t}-{a}" for t in TASKS for a in AGGREGATORS])
def runs(request, cohort, tmp_path_factory):
    """``histo_train`` (2 epochs) and ``histo_savescore`` on its
    ``model_last`` through both stacks' CLI mains from one seeded init."""
    from multimodalbrainsurvival_tpu.cli import histo_extractfeatures as jax_extract
    from multimodalbrainsurvival_tpu.cli import histo_savescore as jax_savescore
    from multimodalbrainsurvival_tpu.cli import histo_train as jax_train
    from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax
    from multimodalbrainsurvival_tpu.train.checkpoint import Checkpointer

    task, aggregator = request.param
    n_classes, label = TASKS[task]
    tmp = tmp_path_factory.mktemp(f"{task}_{aggregator}")
    base = dict(task=task, num_classes=n_classes, target_label=label,
                aggregator=aggregator, aggregator_hdim=48, transformer_layers=2)
    state = _random_state(histo_train.build_mil_model(
        Config(_config(cohort, tmp, **base))), seed=23)
    if aggregator == "attention":
        state["aggregator.vector"] = torch.tensor(
            np.random.default_rng(3).normal(0.0, 0.2, 512), dtype=torch.float32)
    pt = tmp / "init.pt"
    torch.save(state, str(pt))
    flax_init = str(tmp / "init_flax")
    tree = torch_mil_to_flax({k: v.numpy() for k, v in state.items()})
    if aggregator == "transformer":  # the JAX converter knows no transformer
        tree["params"]["aggregator"] = torch_transformer_to_flax(
            {k.removeprefix("aggregator."): v for k, v in state.items()
             if k.startswith("aggregator.")}, num_heads=8)
    Checkpointer().save(flax_init, jax.tree.map(np.asarray, tree), block=True)

    result = {"task": task, "aggregator": aggregator}
    with _transformer_without_dropout():
        for name, main, restore, extra in (
            ("jax", jax_train.main, flax_init, []),
            ("torch", histo_train.main, str(pt), ["--device", "cpu"]),
        ):
            cfg = _config(cohort, tmp / name, restore_path=restore, n_layers_to_train=1,
                          **base)
            k1.attention_pool_backward.calls = 0
            log = _run(main, ["--config", _write(tmp / f"{name}.json", cfg),
                              "--log", "1"] + extra)
            result[name] = (tmp / name, log)
            if name == "torch":
                result["backward_calls"] = k1.attention_pool_backward.calls
        for name, main, model, extra in (
            ("jax", jax_savescore.main, "model_last", []),
            ("torch", histo_savescore.main, "model_last.pt", ["--device", "cpu"]),
            ("jax", jax_extract.main, "model_last", []),
            ("torch", histo_extractfeatures.main, "model_last.pt", ["--device", "cpu"]),
        ):
            serve = dict(_config(cohort, tmp / name, **base),
                         model_path=str(tmp / name / "models/histo_model" / model),
                         output_path=str(tmp / name / "serve"))
            _run(main, ["--config", _write(tmp / f"{name}_serve.json", serve)] + extra)
    return result


def _losses(log, tag):
    return [float(v) for v in re.findall(rf"^{tag} Loss: (\S+)$", log, re.M)]


@pytest.mark.parametrize("tag", ["EPOCH", "TRAIN", "VAL"])
def test_task_printed_losses_match_jax_cli(runs, tag):
    """Each epoch's printed losses, which carry 4 decimals: equal within
    the print's rounding (their full values are compared below)."""
    want, got = _losses(runs["jax"][1], tag), _losses(runs["torch"][1], tag)
    assert len(got) == len(want) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 + 1e-9)


def _metrics(out):
    (path,) = (out / "summary").glob("*_histo_model/metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_task_losses_and_metrics_match_jax_cli(runs):
    """Every scalar both CLIs log (``--log 1``) at full precision: the
    windowed train losses, and each evaluation's loss and task metrics
    (C-index, or accuracy, F1 and AUC) per WSI and per case."""
    want, got = _metrics(runs["jax"][0]), _metrics(runs["torch"][0])
    assert [(r["tag"], r.get("step")) for r in got] == \
        [(r["tag"], r.get("step")) for r in want]
    names = {r["tag"].split("/")[-1] for r in got}
    assert ({"wsi_acc", "case_f1", "case_auc"} if runs["task"] == "classification"
            else {"wsi_CI", "case_CI"}) <= names
    for g, w in zip(got, want):
        if "value" in w and w["tag"] != "train/bags_per_s":
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{w['tag']} at step {w['step']}")


def _frame_columns(task, n_classes):
    if task == "classification":
        return ["id", "label"] + [f"score_{i}" for i in range(n_classes)]
    return ["id", "score", "survival_months", "vital_status"]


def _check_frame(got, want, task):
    n_classes = TASKS[task][0]
    assert list(got.columns) == list(want.columns) == _frame_columns(task, n_classes)
    assert list(got["id"]) == list(want["id"])
    scores = [c for c in got.columns if c.startswith("score")]
    for col in set(got.columns) - set(scores) - {"id"}:
        np.testing.assert_array_equal(got[col], want[col])
    for col in scores:
        assert np.isfinite(got[col]).all()
        np.testing.assert_allclose(got[col], want[col], rtol=1e-4, atol=1e-5, err_msg=col)
    if task == "classification":
        np.testing.assert_allclose(got[scores].sum(axis=1), 1.0, rtol=1e-6)
    else:
        assert (got["score"] <= 0).all()


@pytest.mark.parametrize("tag", ["last", "best"])
@pytest.mark.parametrize("split", SPLITS)
def test_task_train_frames_match_jax_cli(runs, split, tag):
    """survival_bin writes the case-level frame, classification the
    WSI-level one, in both stacks."""
    name = f"outputs/histo_model/{split}_output_{tag}.csv"
    want = pd.read_csv(runs["jax"][0] / name)
    got = pd.read_csv(runs["torch"][0] / name)
    _check_frame(got, want, runs["task"])
    # case ids are c0…, slide ids T0…
    assert got["id"].str.startswith("c" if runs["task"] == "survival_bin" else "T").all()


@pytest.mark.parametrize("split", SPLITS)
def test_task_savescore_matches_jax_cli(runs, split):
    want = pd.read_csv(runs["jax"][0] / f"serve/model_last_pathology_{split}_df.csv",
                       index_col=0)
    got = pd.read_csv(runs["torch"][0] / f"serve/model_last.pt_pathology_{split}_df.csv",
                      index_col=0)
    _check_frame(got, want, runs["task"])
    assert got["id"].str.startswith("c").all()


@pytest.mark.parametrize("split", SPLITS)
def test_task_extract_matches_jax_cli(runs, split):
    """``histo_extractfeatures`` serves each trained model, the transformer
    too: the per-case features of both stacks' ``model_last``. The
    features sit before the head, so the weights' Adam noise (elements
    whose gradient is float32 noise step by up to 2·LR a step in either
    stack, ``tests/test_torch_histo_train.py``) reaches them unreduced: a
    few of the transformer's 1,536 features part by up to 2e-5 of the
    features' scale (measured 4.0e-5 at 2.3), held at 1e-4 of it."""
    (jax_out, _), (torch_out, _) = runs["jax"], runs["torch"]
    cases = f"serve/pathology_cases_{split}.csv"
    assert (torch_out / cases).read_bytes() == (jax_out / cases).read_bytes()
    want = np.loadtxt(jax_out / f"serve/pathology_features_{split}.csv", delimiter=",")
    got = np.loadtxt(torch_out / f"serve/pathology_features_{split}.csv", delimiter=",")
    assert got.shape == want.shape and got.shape[1] == 512
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_task_runs_train_the_aggregator(runs):
    """K1's backward runs once a train step with ``attention`` (15 bags of
    2 in batches of 3: 5 steps an epoch) and never with the transformer;
    the aggregator trains at ``n_layers_to_train`` 1."""
    want = 10 if runs["aggregator"] == "attention" else 0
    assert runs["backward_calls"] == want
    save = runs["torch"][0] / "models/histo_model"
    last = torch.load(save / "model_last.pt", weights_only=True)
    start = torch.load(save.parent.parent.parent / "init.pt", weights_only=True)
    moved = [k for k in last if k.startswith("aggregator.")
             and not torch.equal(last[k], start[k])]
    assert moved
    assert torch.equal(last["resnet.layer4.0.conv1.weight"],
                       start["resnet.layer4.0.conv1.weight"])


def test_default_task_is_classification_and_runs(cohort, tmp_path):
    """The reference's default config (no ``task``: classification) trains
    on the CPU."""
    cfg = _config(cohort, tmp_path / "out", num_epochs=1, num_classes=2,
                  target_label="label")
    del cfg["task"]
    assert Config(cfg).task == "classification"
    log = _run(histo_train.main, ["--config", _write(tmp_path / "cfg.json", cfg),
                                  "--device", "cpu"])
    assert "wsi  | acc" in log
    frame = pd.read_csv(tmp_path / "out/outputs/histo_model/val_output_last.csv")
    assert list(frame.columns) == ["id", "label", "score_0", "score_1"]
