"""The variant timer's substitutions (``tools/kernel_variants.py``) against the
committed kernel sources, on the CPU: a kernel edit that moves a line a
variant substitutes fails here, not in a chip run."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "kernel_variants", os.path.join(REPO, "tools", "kernel_variants.py"))
kernel_variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_variants)


@pytest.mark.parametrize("name", sorted(kernel_variants.SPLITK_VARIANTS))
def test_splitk_variant_applies_to_the_committed_sources(name):
    """Every substitution of a K1 / K2a variant finds its text, and only
    ``committed`` leaves the sources as they are."""
    committed = {f: (kernel_variants.build.CSRC / f).read_text()
                 for f in kernel_variants.SPLITK_FILES}
    out = kernel_variants.splitk_variant_sources(name)
    changed = sorted(f for f in committed if out[f] != committed[f])
    assert bool(changed) == (name != "committed"), changed


@pytest.mark.parametrize("name", sorted(kernel_variants.K2B_VARIANTS))
def test_k2b_variant_applies_to_the_committed_source(name):
    src = (kernel_variants.build.CSRC / "dropout_matmul.cu").read_text()
    out = kernel_variants.patched(src, kernel_variants.K2B_VARIANTS[name], name)
    assert (out != src) == (name != "committed")


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_k4_variant_applies_to_the_committed_source(name):
    src = (kernel_variants.build.CSRC / "fused_stage.cu").read_text()
    out = kernel_variants.patched(src, kernel_variants.VARIANTS[name], name)
    assert (out != src) == (name != "committed")


def test_splitk_variant_with_missing_text_is_refused(monkeypatch):
    monkeypatch.setitem(kernel_variants.SPLITK_VARIANTS, "stale",
                        [("a line no source has", "x")])
    with pytest.raises(ValueError, match="stale"):
        kernel_variants.splitk_variant_sources("stale")
