"""The RNA slice's modules against the JAX package on the CPU: the CSV
dataset, the model, the weight converter, the Cox gradient, and the
optimizer (Adam groups, LR schedules, global-norm clipping).

Inputs are made with numpy from fixed seeds and go through both stacks.
Tolerances: batches exactly; model outputs and the Cox gradient at
``rtol=1e-5`` (float32 sums in another order); optimizer trajectories at
``rtol=1e-5, atol=1e-6`` after 6 steps that move the weights by up to 0.06:
optax takes Adam's bias corrections in float32, where 1 − 0.999 is 1.3e-5
off, and torch in float64, so every update differs by ≈6e-6 of itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalbrainsurvival_torch.data import RNATableDataset
from multimodalbrainsurvival_torch.models import RNAEncoder, RNAOnlyModel
from multimodalbrainsurvival_torch.models.convert import flax_rna_to_torch
from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss
from multimodalbrainsurvival_torch.train import TrainSettings
from multimodalbrainsurvival_torch.train.loop import make_loss_fn
from multimodalbrainsurvival_torch.train.optim import (
    build_grouped_optimizer,
    clip_by_global_norm,
    relative_lr_schedule,
    wrap_optimizer,
)
from multimodalbrainsurvival_tpu.models.convert import torch_rna_to_flax
from tests.helpers import make_survival_csv


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """An RNA CSV with a BOM, id and label columns around the genes, a
    column that contains ``rna_`` inside its name and one that does not."""
    tmp = tmp_path_factory.mktemp("rna_table")
    path = tmp / "rna.csv"
    df = make_survival_csv(str(tmp / "plain.csv"), [f"c{i}" for i in range(11)],
                           n_rna=7, seed=3)
    df["xrna_extra"] = np.arange(11, dtype=np.float32) / 3
    df["RNA_upper"] = 1.0
    df["survival_bin"] = np.arange(11) % 4
    path.write_text(df.to_csv(index=False), encoding="utf-8-sig")
    return str(path)


def test_rna_columns_labels_and_bom_match_jax(table):
    from multimodalbrainsurvival_tpu.data.tables import RNATableDataset as JaxTable

    ours, theirs = RNATableDataset(table), JaxTable(table)
    assert ours.feature_columns == theirs.feature_columns
    assert "xrna_extra" in ours.feature_columns and "RNA_upper" not in ours.feature_columns
    np.testing.assert_array_equal(ours.features, theirs.features)
    assert ours.case == theirs.case
    assert ours.labels_float.keys() == theirs.labels_float.keys()
    assert ours.labels_int.keys() == theirs.labels_int.keys() == {"survival_bin"}
    for k, v in {**theirs.labels_float, **theirs.labels_int}.items():
        got = {**ours.labels_float, **ours.labels_int}[k]
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("kwargs", [
    {}, {"shuffle": True, "seed": 1111}, {"shuffle": True, "seed": 1112, "pad": False},
    {"shuffle": True, "seed": 5, "skip_batches": 1},
], ids=["ordered", "shuffled", "unpadded", "skip_1"])
def test_batches_match_jax(table, kwargs):
    from multimodalbrainsurvival_tpu.data.tables import RNATableDataset as JaxTable

    ours = list(RNATableDataset(table).batches(4, **kwargs))
    theirs = list(JaxTable(table).batches(4, **kwargs))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if k == "case":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_empty_rna_columns_raise(tmp_path):
    path = tmp_path / "no_rna.csv"
    path.write_text("case,survival_months,vital_status,gene_1\nc0,1.5,1,0.3\n")
    with pytest.raises(ValueError, match="rna_"):
        RNATableDataset(str(path))


def _jax_params(in_features, hidden, seed=0):
    from multimodalbrainsurvival_tpu.models.rna import RNAEncoder as JaxEncoder
    from multimodalbrainsurvival_tpu.models.rna import RNAOnlyModel as JaxModel

    model = JaxModel(encoder=JaxEncoder(hidden_dims=hidden, dropout=0.0))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, in_features)))["params"]
    # a non-zero head bias, so the test would see it dropped
    params = jax.tree.map(np.asarray, params)
    params["final"]["bias"] = np.full_like(params["final"]["bias"], 0.25)
    return model, params


@pytest.mark.parametrize("hidden", [(4096, 2048), (24, 12)])
def test_model_forward_and_extract_match_jax(hidden):
    model, params = _jax_params(16, hidden)
    x = np.random.default_rng(4).normal(size=(9, 16)).astype(np.float32)
    ours = RNAOnlyModel(RNAEncoder(16, hidden, dropout=0.5)).eval()
    ours.load_state_dict(flax_rna_to_torch(params))
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
        emb = ours.extract(torch.from_numpy(x)).numpy()
        head = ours.from_embedding(torch.from_numpy(emb)).numpy()
    want = np.asarray(model.apply({"params": params}, x))
    want_emb = np.asarray(model.apply({"params": params}, x, method="extract"))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(emb, want_emb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(head, want, rtol=1e-5, atol=1e-6)
    assert emb.shape == (9, hidden[-1])


def test_state_dict_has_the_reference_keys_and_converters_invert():
    _, params = _jax_params(16, (24, 12))
    state = flax_rna_to_torch(params)
    model = RNAOnlyModel(RNAEncoder(16, (24, 12)))
    assert set(model.state_dict()) == set(state) == {
        f"{m}.{leaf}" for m in ("rna_mlp.1", "rna_mlp.4", "final_mlp.0")
        for leaf in ("weight", "bias")}
    back = torch_rna_to_flax({k: v.numpy() for k, v in state.items()})["params"]
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_train_mode_goes_through_dropout_matmul(monkeypatch):
    """Every Linear of the encoder in train mode is one ``DropoutMatmul``
    with the Dropout's p and its own seed; eval mode never calls it; at
    p = 0 both modes agree."""
    from multimodalbrainsurvival_torch.kernels import dropout_matmul as k2

    calls = []
    orig = k2.DropoutMatmul.apply
    monkeypatch.setattr(k2.DropoutMatmul, "apply",
                        lambda x, w, seed, p, *offsets: calls.append((tuple(w.shape), seed, p))
                        or orig(x, w, seed, p, *offsets))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 16)).astype(np.float32))
    model = RNAOnlyModel(RNAEncoder(16, (24, 12), dropout=0.0))
    with torch.no_grad():
        eval_out = model.eval()(x)
        assert calls == []
        train_out = model.train()(x, torch.Generator().manual_seed(0))
    torch.testing.assert_close(train_out, eval_out)
    model = RNAOnlyModel(RNAEncoder(16, (24, 12), dropout=0.3)).train()
    calls.clear()
    model(x, torch.Generator().manual_seed(0))
    (w0, s0, p0), (w1, s1, p1) = calls
    assert (w0, w1, p0, p1) == ((24, 16), (12, 24), 0.3, 0.3) and s0 != s1
    calls.clear()
    model(x, torch.Generator().manual_seed(0))
    assert [c[1] for c in calls] == [s0, s1]  # one generator state, one set of seeds


@pytest.mark.parametrize("reference_parity", [True, False])
@pytest.mark.parametrize("n_real", [10, 7, 1])
def test_cox_gradient_matches_jax_grad(reference_parity, n_real):
    """∂loss/∂scores on a padded batch with tied times and no NaN from the
    pads' ``-inf``."""
    from multimodalbrainsurvival_tpu.ops.cox import cox_partial_likelihood_loss as jax_cox

    rng = np.random.default_rng(n_real)
    scores = rng.normal(size=10).astype(np.float32) * 2
    times = rng.choice([3.0, 7.5, 12.0, 40.0, 41.0], size=10).astype(np.float32)
    events = (rng.random(10) < 0.6).astype(np.float32)
    mask = np.arange(10) < n_real
    want_loss, want = jax.value_and_grad(
        lambda s: jax_cox(s, times, events, mask, reference_parity=reference_parity))(
        jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    loss = cox_partial_likelihood_loss(s, torch.from_numpy(times), torch.from_numpy(events),
                                       torch.from_numpy(mask),
                                       reference_parity=reference_parity)
    loss.backward()
    assert torch.isfinite(s.grad).all()
    assert torch.all(s.grad[~torch.from_numpy(mask)] == 0)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("reference_parity", [True, False])
def test_loss_fn_follows_reference_parity(reference_parity):
    loss_fn, keys = make_loss_fn(TrainSettings(reference_parity=reference_parity))
    rng = np.random.default_rng(0)
    arrays = {"survival_months": torch.from_numpy(rng.uniform(1, 50, 8).astype(np.float32)),
              "vital_status": torch.tensor([1.0, 0, 1, 1, 0, 1, 0, 1])}
    out = torch.from_numpy(rng.normal(size=(8, 1)).astype(np.float32))
    mask = torch.ones(8, dtype=torch.bool)
    want = cox_partial_likelihood_loss(out[:, 0], arrays["survival_months"],
                                       arrays["vital_status"], mask,
                                       reference_parity=reference_parity)
    assert keys == ("survival_months", "vital_status")
    assert torch.equal(loss_fn(out, arrays, mask), want)


@pytest.mark.parametrize("kind,kw", [
    ("constant", {"warmup_steps": 3}),
    ("cosine", {"warmup_steps": 2, "min_factor": 0.1}),
    ("linear", {}),
    ("step", {"warmup_steps": 1, "step_every": 2, "step_gamma": 0.5, "min_factor": 0.2}),
])
def test_schedule_factor_matches_jax(kind, kw):
    from multimodalbrainsurvival_tpu.train.optim import relative_lr_schedule as jax_schedule

    ours = relative_lr_schedule(kind, total_steps=10, **kw)
    theirs = jax_schedule(kind, total_steps=10, **kw)
    for count in range(14):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6)


def _grads(model, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=p.shape) * scale).astype(np.float32)
            for k, p in model.named_parameters()}


@pytest.mark.parametrize("max_norm", [3.0, 300.0], ids=["clipped", "unclipped"])
def test_clip_matches_optax(max_norm):
    model = RNAOnlyModel(RNAEncoder(16, (24, 12)))
    grads = _grads(model, 0)
    params = list(model.parameters())
    for p, (k, g) in zip(params, grads.items()):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm(params, max_norm)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(g) for k, g in grads.items()}, optax.EmptyState())
    assert (float(norm) > max_norm) == (max_norm == 3.0)
    for p, k in zip(params, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("schedule,clip", [
    (None, None), ("cosine", None), (None, 30.0), (None, 3000.0), ("step", 30.0),
], ids=["plain", "cosine", "clipped", "unclipped", "step_clipped"])
def test_optimizer_trajectory_matches_jax(schedule, clip):
    """Six steps of the RNA groups (``lr_rna`` for ``rna_mlp``, ``lr_mlp``
    for ``final_mlp``, coupled weight decay) from the same weights and the
    same gradients, against ``build_grouped_optimizer`` + ``torch_adam`` +
    ``wrap_optimizer`` of the JAX package. The global norm of a step's
    gradient is ≈ 27: clipped at 30 only sometimes, at 3000 never."""
    from multimodalbrainsurvival_tpu.train import optim as jax_optim

    model = RNAOnlyModel(RNAEncoder(16, (24, 12)))
    kw = {"step": {"warmup_steps": 1, "step_every": 2, "step_gamma": 0.5},
          "cosine": {"warmup_steps": 2}}.get(schedule, {})
    ours = wrap_optimizer(
        build_grouped_optimizer(model, [("rna", "rna_mlp.", 1e-2), ("mlp", "final_mlp.", 3e-3)],
                                weight_decay=1e-2),
        schedule=relative_lr_schedule(schedule, total_steps=6, **kw) if schedule else None,
        grad_clip_norm=clip)
    params = torch_rna_to_flax({k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()})["params"]
    params = jax.tree.map(jnp.asarray, params)
    tx, _ = jax_optim.build_grouped_optimizer(params, [
        ("rna", jax_optim.path_prefix_match("encoder"), jax_optim.torch_adam(1e-2, 1e-2)),
        ("mlp", jax_optim.path_prefix_match("final"), jax_optim.torch_adam(3e-3, 1e-2)),
    ])
    tx = jax_optim.wrap_optimizer(
        tx, schedule=jax_optim.relative_lr_schedule(schedule, total_steps=6, **kw)
        if schedule else None, grad_clip_norm=clip)
    state = tx.init(params)
    for step in range(6):
        grads = _grads(model, step, scale=1.0 + step / 3)
        ours.zero_grad()
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        ours.step()
        jgrads = jax.tree.map(jnp.asarray, torch_rna_to_flax(grads)["params"])
        updates, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
    got = torch_rna_to_flax({k: v.detach().numpy() for k, v in model.state_dict().items()})
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6),
                 got["params"], params)
