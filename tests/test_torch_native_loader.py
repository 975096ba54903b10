"""The port's C++ batch assembler (``data/native.py``, ``native/patch_loader.cc``
compiled as it is) and ``pack_patches``, on the CPU.

Batches through the assembler are byte for byte the port's per-bag path's
(``_load_batch_plain``) and the JAX dataset's (its cv2 path), for PNG
directories, packed shards, shards of another size (resized by
``resize_linear``) and the joint subclass; a PNG the loader cannot decode
raises naming the file. The build is atomic: four processes that build
into one empty directory at once all load a whole library, and none of it
touches the JAX package's ``native/libpatchloader.so``. A failed build
raises (and fails a test: no test here skips). The port's ``pack_patches`` writes the JAX
``pack_patch_dir``'s shards.
"""

import hashlib
import os
import shutil
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from multimodalbrainsurvival_torch.cli import pack_patches
from multimodalbrainsurvival_torch.data import PatchBagDataset, PatchBagRNADataset, native
from multimodalbrainsurvival_torch.data.patches import BATCH_BUFFERS
from multimodalbrainsurvival_torch.data.tiler import pack_patch_dir
from multimodalbrainsurvival_tpu.data import PatchBagDataset as JaxPatchBagDataset
from multimodalbrainsurvival_tpu.data import PatchBagRNADataset as JaxPatchBagRNADataset
from multimodalbrainsurvival_tpu.data.tiler import pack_patch_dir as jax_pack_patch_dir
from tests.helpers import make_patch_dir, make_survival_csv

REPO = Path(__file__).resolve().parents[1]
JAX_LIBRARY = REPO / "native" / "libpatchloader.so"


@pytest.fixture
def cohort(tmp_path):
    root = tmp_path / "patches"
    for i, (w, n) in enumerate((("W1", 7), ("W2", 5), ("W3", 6))):
        make_patch_dir(str(root), w, n, img_size=32, seed=i)
    csv = tmp_path / "joint.csv"
    make_survival_csv(str(csv), ["c1", "c2", "c3"], wsi_names=["W1.svs", "W2.svs", "W3.svs"],
                      n_rna=6)
    return str(root), str(csv)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], k
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _plain_batches(ds, batch_size):
    with ThreadPoolExecutor(2) as pool:
        return [ds._load_batch_plain(np.arange(len(ds))[s:s + batch_size], batch_size, pool)
                for s in range(0, len(ds), batch_size)]


@pytest.mark.parametrize("source,img_size", [("png", 32), ("shard", 32), ("mixed", 32),
                                             ("shard_resized", 24), ("joint", 32)])
def test_assembler_batches_equal_plain_and_jax(cohort, source, img_size):
    root, csv = cohort
    if source != "png":
        for w in (("W1",) if source == "mixed" else ("W1", "W2", "W3")):
            jax_pack_patch_dir(os.path.join(root, w))
    ours, theirs = ((PatchBagRNADataset, JaxPatchBagRNADataset) if source == "joint"
                    else (PatchBagDataset, JaxPatchBagDataset))
    kw = dict(img_size=img_size, bag_size=2, keep_remainder=True)
    got = list(ours(root, csv, **kw).batches(3, num_threads=2))
    _assert_batches_equal(got, _plain_batches(ours(root, csv, **kw), 3))
    want = list(theirs(root, csv, decoder="cv2", **kw).batches(3, num_threads=2))
    _assert_batches_equal(got, want)


def test_batch_buffers_are_reused_only_once_released(cohort):
    """Batches dropped by their consumer lend their buffers to later ones,
    which carry no stale pixels (short bags and a padded batch); batches
    kept alive each hold their own."""
    root, csv = cohort
    kw = dict(img_size=32, bag_size=3, keep_remainder=True)
    ds = PatchBagDataset(root, csv, **kw)
    want = _plain_batches(PatchBagDataset(root, csv, **kw), 4)
    seen = set()
    for _ in range(3):
        for got, plain in zip(ds.batches(4, num_threads=2), want):
            _assert_batches_equal([got], [plain])
            seen.add(got["patch_bag"].ctypes.data)
    assert len(seen) <= BATCH_BUFFERS
    kept = list(ds.batches(4, num_threads=2)) + list(ds.batches(4, num_threads=2))
    _assert_batches_equal(kept, want + want)
    assert len({b["patch_bag"].ctypes.data for b in kept}) == len(kept)


def test_a_corrupt_png_raises_naming_the_file(cohort):
    root, csv = cohort
    bad = os.path.join(root, "W2", "W2_patch_3.png")
    with open(bad, "wb") as f:
        f.write(b"not a png at all")
    ds = PatchBagDataset(root, csv, img_size=32, bag_size=2)
    with pytest.raises(ValueError, match="W2_patch_3.png.*not a PNG"):
        list(ds.batches(2, num_threads=2))
    os.remove(bad)
    with pytest.raises(ValueError, match="W2_patch_3.png.*cannot open"):
        list(ds.batches(2, num_threads=2))


def _settled_jax_library() -> tuple:
    """(mtime, bytes digest) of the JAX package's library once no build of
    it is under way (its own tests build it, in place, on first use), or
    None where it is not built."""
    if not JAX_LIBRARY.exists():
        return None
    while time.time() - JAX_LIBRARY.stat().st_mtime < 10:
        time.sleep(1)
    return (JAX_LIBRARY.stat().st_mtime_ns,
            hashlib.sha256(JAX_LIBRARY.read_bytes()).hexdigest())


def test_four_processes_build_at_once_and_load_a_whole_library(tmp_path):
    before = _settled_jax_library()
    build_dir = tmp_path / "build"
    img = tmp_path / "p"
    make_patch_dir(str(img), "S", 2, img_size=8, seed=3)
    code = textwrap.dedent(f"""
        import numpy as np
        from pathlib import Path
        from multimodalbrainsurvival_torch.data import native
        native.BUILD_DIR = Path({str(build_dir)!r})
        out = np.zeros((2, 8, 8, 3), np.uint8)
        native.decode_patch_batch([{str(img / 'S' / 'S_patch_0.png')!r},
                                   {str(img / 'S' / 'S_patch_1.png')!r}], out, 2)
        print(int(out.sum()))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    sums = {out.strip() for out, _ in outs}
    assert len(sums) == 1 and int(sums.pop()) > 0
    built = sorted(os.listdir(build_dir))
    assert built == [native.library_path(build_dir).name]  # no partial or temp file
    assert native.library_path(build_dir).parent != JAX_LIBRARY.parent
    assert _settled_jax_library() == before


def test_the_jax_library_is_untouched_by_the_ports_build_and_loads(cohort):
    """The port's default build, its dataset reads and its ``pack_patches``
    leave the JAX package's library as they found it (mtime and bytes)."""
    root, csv = cohort
    before = _settled_jax_library()
    native.load()
    pack_patches.main(["--patch_path", root, "--num_threads", "2"])
    list(PatchBagDataset(root, csv, img_size=32, bag_size=2).batches(2))
    assert _settled_jax_library() == before
    assert "libpatchloader.so" not in {p.name for p in native.library_path().parent.iterdir()}


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "patch_loader.cc"
    broken.write_text("int assemble_patch_batch( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*: error:"):
        native.build(tmp_path / "build")
    assert not any((tmp_path / "build").iterdir())  # the temp file is removed


def test_pack_patches_equals_jax_pack_patch_dir(cohort, tmp_path):
    root, _ = cohort
    theirs = tmp_path / "theirs"
    shutil.copytree(root, theirs)
    pack_patches.main(["--patch_path", root, "--num_threads", "2"])
    for w in ("W1", "W2", "W3"):
        assert jax_pack_patch_dir(str(theirs / w)) > 0
        got = np.load(os.path.join(root, w, "patches.npy"))
        want = np.load(theirs / w / "patches.npy")
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # idempotent on mtime: a shard newer than loc.txt is kept
    shard = os.path.join(root, "W1", "patches.npy")
    stamp = os.stat(shard).st_mtime_ns
    assert pack_patch_dir(os.path.join(root, "W1")) == 7
    assert os.stat(shard).st_mtime_ns == stamp
