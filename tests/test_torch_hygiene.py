"""Rules of the port: no JAX in its import graph, no silent CPU fallback,
and weights that round-trip between the two packages."""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import multimodalbrainsurvival_torch
from multimodalbrainsurvival_torch.cli import (
    histo_extractfeatures,
    histo_savescore,
    histo_train,
    rna_extractfeatures,
    rna_savescore,
    rna_train,
)
from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.device import resolve_device
from multimodalbrainsurvival_torch.models.convert import (
    flax_mil_to_torch,
    load_reference_state_dict,
)
from multimodalbrainsurvival_tpu.models.convert import torch_mil_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter, leaves no ``jax`` and no ``multimodalbrainsurvival_tpu``
    module behind."""
    modules = [
        m.name for m in pkgutil.walk_packages(
            multimodalbrainsurvival_torch.__path__, "multimodalbrainsurvival_torch."
        )
    ]
    assert "multimodalbrainsurvival_torch.kernels.attention_pool" in modules
    assert "multimodalbrainsurvival_torch.kernels.qmm_requant" in modules
    assert "multimodalbrainsurvival_torch.models.quantize" in modules
    for name in ("kernels.dropout_matmul", "models.rna", "data.tables", "train.optim",
                 "train.checkpoint", "cli.rna_train", "cli.rna_savescore",
                 "cli.rna_extractfeatures", "kernels.fused_stage", "models.serving"):
        assert f"multimodalbrainsurvival_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'flax', 'multimodalbrainsurvival_tpu')))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("main", [
    histo_savescore.main, histo_extractfeatures.main, rna_train.main,
    rna_savescore.main, rna_extractfeatures.main, histo_train.main,
])
def test_cli_without_card_raises_unless_cpu_asked(main, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_path": "missing.pt"}))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--config", str(cfg)])


def test_resolve_device_sets_full_float32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        resolve_device("mps")


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("aggregator", ["identity", "attention"])
def test_flax_mil_to_torch_inverts_torch_mil_to_flax(arch, aggregator):
    model = build_mil_model(Config({"model_name": arch, "aggregator": aggregator}))
    rng = np.random.default_rng(0)
    state = {k: torch.tensor(rng.normal(size=v.shape), dtype=v.dtype)
             if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    flax = torch_mil_to_flax({k: v.numpy() for k, v in state.items()})
    back = flax_mil_to_torch(flax["params"], flax["batch_stats"])
    assert set(back) == set(state)
    for k, v in state.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    model.load_state_dict(back)


def test_load_reference_state_dict_drops_resnet_classifier(tmp_path):
    model = build_mil_model(Config({"model_name": "resnet18"}))
    state = dict(model.state_dict())
    state["resnet.fc.weight"] = torch.zeros(1000, 512)
    state["resnet.fc.bias"] = torch.zeros(1000)
    path = tmp_path / "ref.pt"
    torch.save({"state_dict": state}, str(path))
    loaded = load_reference_state_dict(str(path))
    assert not any(k.startswith("resnet.fc.") for k in loaded)
    model.load_state_dict(loaded)


def test_kernel_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """A changed ``csrc/`` header (``#include "x.cuh"``, directly or through
    another header) names another library, so it is rebuilt; an angle-bracket
    include and a change elsewhere do not."""
    from multimodalbrainsurvival_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("int b2;\n")
    assert build.library_path("k") != first
    assert first.name.startswith("libk-") and first.suffix == ".so"


def test_every_kernel_source_includes_only_files_in_csrc():
    from multimodalbrainsurvival_torch.kernels import build

    for name in build.KERNEL_SOURCES:
        for path in build._sources(name):
            assert path.is_file() and path.parent == build.CSRC, path
