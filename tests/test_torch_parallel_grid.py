"""The four train CLIs under ``mesh: {"dp": 2, "mp": 2}`` in a gloo world of
4 processes on the CPU: the two ranks of each ``dp`` row compute the same
step (the parameters replicated over ``mp``, as the JAX CLIs place them), so
the gradient reduction must count them once. First-step losses and
gradients against the port's world-of-one runs at the tolerances of
``tests/test_torch_parallel_rna.py`` and ``tests/test_torch_parallel_histo
.py`` (the cohorts are theirs), and at ``dropout: 0`` the RNA step against
the JAX package on a ``(2, 2)`` virtual mesh. The world-of-one runs, the
witness and the JAX step are made in the test process while the world
works.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from tests import test_torch_parallel_histo as histo
from tests import test_torch_parallel_rna as rna

GRID = {"dp": 2, "mp": 2}
#: name → (module of the cohort, cli, overrides)
JOBS = {
    "rna": (rna, "rna_train", {}),
    "rna_d0": (rna, "rna_train", {"dropout": 0.0}),
    "feature": (rna, "feature_train", {}),
    "histo": (histo, "histo_train", {}),
    "joint": (histo, "joint_train", {"freeze_bn": True}),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(tmp, name, **overrides):
    module, cli, base = JOBS[name]
    cfg = dict(base, **overrides)
    if cli == "feature_train":
        cfg["restore_path"] = str(tmp / "init_feature.pt")
    return module._config(tmp, name if "mesh" in cfg else f"{name}_w1", **cfg)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_grid")
    from multimodalbrainsurvival_torch.cli import rna_train
    from multimodalbrainsurvival_torch.cli.feature_train import build_feature_model
    from multimodalbrainsurvival_torch.config import Config
    from tests.helpers import make_survival_csv

    for split, n, seed in (("train", 24, 5), ("val", 12, 6), ("test", 12, 7)):
        make_survival_csv(str(tmp / f"{split}.csv"), [f"{split}{i}" for i in range(n)],
                          n_rna=rna.N_GENES, n_feature=rna.N_FEATURES, seed=seed)
    torch.manual_seed(3)
    torch.save(rna_train.build_rna_model(None, rna.N_GENES).state_dict(), str(tmp / "init.pt"))
    torch.manual_seed(4)
    torch.save(build_feature_model(Config({}), rna.N_FEATURES).state_dict(),
               str(tmp / "init_feature.pt"))
    histo._cohort(tmp)
    jobs = []
    for name in JOBS:
        cfg = _config(tmp, name, mesh=GRID)
        jobs.append({"cli": JOBS[name][1], "argv": ["--config", cfg, "--device", "cpu",
                                                     "--seed", str(rna.SEED)],
                     "grads": str(tmp / f"{name}.grads.pt")})
    histo._initial_weights(tmp, "histo")
    out = tmp / "codes"
    out.mkdir()

    def references():
        for name in JOBS:
            _world_of_one(tmp, name)
        histo._witness(tmp, "histo_dp")
        _jax_grid_step(tmp)

    results, _ = rna.worker.run_world(4, rna._write_json(tmp / "jobs.json", jobs), str(out),
                                      str(tmp / "logs"), references)
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{log[-3000:]}"
    codes = [json.loads((out / f"codes{r}.json").read_text()) for r in range(4)]
    for name, all_codes in zip(JOBS, zip(*codes)):
        assert all_codes == (0,) * 4, (name, all_codes)
    yield tmp
    # a suite run keeps its temporary files on one disk
    shutil.rmtree(tmp, ignore_errors=True)


_REFERENCES: dict = {}


def _world_of_one(tmp, name) -> dict:
    """``name``'s first step in this process, without a mesh (made once)."""
    key = (str(tmp), name)
    if key not in _REFERENCES:
        argv = ["--config", _config(tmp, name), "--device", "cpu", "--seed", str(rna.SEED)]
        record = {}
        assert rna.worker.run_cli(JOBS[name][1], argv, record) == 0
        _REFERENCES[key] = record
    return _REFERENCES[key]


def _jax_grid_step(tmp) -> tuple[float, dict]:
    key = (str(tmp), "jax")
    if key not in _REFERENCES:
        _REFERENCES[key] = rna.jax_rna_step(tmp, GRID)
    return _REFERENCES[key]


@pytest.mark.parametrize("name", list(JOBS))
def test_grid_first_step_matches_the_world_of_one(world, name):
    got = torch.load(str(world / f"{name}.grads.pt"))
    want = _world_of_one(world, name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    floor = 0.0
    if name == "histo":
        witness = histo._witness(world, "histo_dp")["grads"]
        floor = 2 * max(float((witness[k] - want["grads"][k]).abs().max()) for k in witness)
    rna._assert_grads_close(got["grads"], want["grads"], floor)


def test_grid_rna_at_dropout_0_matches_jax(world):
    got = torch.load(str(world / "rna_d0.grads.pt"))
    loss, want = _jax_grid_step(world)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    rna._assert_grads_close(got["grads"], want)
