"""Data and bag parallelism of ``joint_train`` in a gloo world of 2
processes on the CPU: ``tests/test_torch_parallel_histo.py``'s cohort,
configs and tolerances (its module docstring), with the joint model's
dropout at 0.5 and its ResNet's BatchNorm statistics held (``freeze_bn``)
under ``{"dp": 2}`` and ``{"dp": 1, "mp": 2, "shard_bag": true}``, and
without dropout and augmentation against the JAX package on a ``dp=2``
virtual mesh. The world-of-one run and the JAX step are made in the test
process while the world works.
"""

import json

import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.data import PatchBagRNADataset
from multimodalbrainsurvival_torch.models.convert import flax_joint_to_torch
from tests import test_torch_parallel_histo as histo

JOINT = ("joint_dp", "joint_bag", "joint_plain_dp")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_JAX: dict = {}


def _jax_joint(tmp) -> tuple[float, dict]:
    """The JAX step of ``joint_plain_dp`` on a ``dp=2`` virtual mesh (made
    once)."""
    from multimodalbrainsurvival_tpu.cli.joint_train import build_joint_model as jax_build
    from multimodalbrainsurvival_tpu.config import Config as JaxConfig
    from multimodalbrainsurvival_tpu.models.convert import torch_joint_to_flax

    if str(tmp) not in _JAX:
        cfg = json.loads((tmp / "joint_plain_dp.json").read_text())
        state = {k: v.numpy() for k, v in torch.load(str(tmp / "joint.pt")).items()}
        loss, grads = histo._jax_step(
            jax_build(JaxConfig(cfg)), torch_joint_to_flax(state), ("rna_data",),
            histo._first_batch(tmp, "joint_plain_dp", PatchBagRNADataset))
        _JAX[str(tmp)] = (loss, flax_joint_to_torch(grads))
    return _JAX[str(tmp)]


def _references(tmp):
    histo._world_of_one(tmp, "joint_dp")
    _jax_joint(tmp)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    yield from histo.run_world(tmp_path_factory, JOINT, _references)


@pytest.mark.parametrize("name", ["joint_dp", "joint_bag"])
def test_first_step_and_bn_statistics_match_the_world_of_one(world, name):
    """The joint model's first-step loss and gradients (its dropout masks
    at the rank's rows, its augmentation drawn for the global batch on
    every rank) equal the port's one-process run at the JAX tolerance."""
    histo.check_first_step(world, name)


def test_joint_dp_without_dropout_matches_jax(world):
    got = torch.load(str(world / "joint_plain_dp.grads.pt"))
    loss, want = _jax_joint(world)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    histo._assert_grads_close(got["grads"], {k: want[k] for k in got["grads"]})
