"""Rules of the port: no JAX in its import graph, no silent CPU fallback,
and weights that round-trip between the two packages."""

import json
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import multimodalbrainsurvival_torch
from multimodalbrainsurvival_torch.cli import (
    feature_savescore,
    feature_train,
    histo_extractfeatures,
    histo_savescore,
    histo_train,
    joint_savescore,
    joint_train,
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
from tests._torch_jax_tiff import jax_native_tiff_slide

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
                 "cli.rna_extractfeatures", "kernels.fused_stage", "models.serving",
                 "models.fusion", "cli.feature_train", "cli.feature_savescore",
                 "cli.joint_train", "cli.joint_savescore", "ops.coxnet", "frames",
                 "cli.merge_scores", "cli.concat_features", "cli.late_fusion",
                 "cli.pack_patches", "data.native", "data.tiler", "data.device_cache",
                 "data.opencv_compat", "utils.native_tiff", "data.tiff", "data.codecs",
                 "cli.wsi2patches",
                 "cli.slide_extractfeatures", "cli.slide_joint_savescore",
                 "cli.attention_heatmap", "kernels.ops", "artifact", "cli.export_model",
                 "cli.serve", "cli.convert_checkpoint", "ops.survival", "data.genes",
                 "cli.evaluate_scores", "cli.validate_data", "cli.cv_run", "cli.sweep",
                 "parallel", "parallel.mesh", "parallel.sharding", "parallel.launch",
                 "parallel.dryrun"):
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
    feature_train.main, feature_savescore.main, joint_train.main, joint_savescore.main,
])
def test_cli_without_card_raises_unless_cpu_asked(main, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_path": "missing.pt"}))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--config", str(cfg)])


@pytest.mark.parametrize("main", [
    rna_train.main, feature_train.main, histo_train.main, joint_train.main,
    histo_extractfeatures.main,
])
def test_mesh_clis_without_card_raise_unless_cpu_asked(main, tmp_path, monkeypatch):
    """The CLIs that take a ``mesh`` still default to ``cuda`` and raise
    without a card before they join a process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_path": "missing.pt", "mesh": {"dp": 2}}))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--config", str(cfg)])


def test_dryrun_without_card_raises_unless_cpu_asked(monkeypatch):
    from multimodalbrainsurvival_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--world", "2"])


@pytest.mark.parametrize("name, argv", [
    ("slide_extractfeatures", ["--config", "{cfg}"]),
    ("slide_joint_savescore", ["--config", "{cfg}"]),
    ("export_model", ["--config", "{cfg}"]),
    ("wsi2patches", ["--wsi_path", "{tmp}", "--patch_path", "{tmp}", "--mask_path", "{tmp}"]),
    ("attention_heatmap", ["--patches_csv", "{tmp}/missing.csv"]),
    ("serve", ["--artifact", "{tmp}/missing", "--port", "0"]),
    ("convert_checkpoint", ["--torch_path", "{tmp}/missing.pt", "--arch", "histo",
                            "--output", "{tmp}/out.pt"]),
])
def test_streaming_and_serving_clis_without_card_raise_unless_cpu_asked(
        name, argv, tmp_path, monkeypatch):
    import importlib

    module = importlib.import_module(f"multimodalbrainsurvival_torch.cli.{name}")
    main = getattr(module, "main")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_path": "missing.pt",
                               "slide_csv_path": str(tmp_path / "missing.csv"),
                               "export_path": str(tmp_path / "art")}))
    argv = [a.format(cfg=cfg, tmp=tmp_path) for a in argv]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
    # on the CPU it gets past the device to the missing input
    with pytest.raises((FileNotFoundError, SystemExit, OSError)):
        main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("name, argv", [
    ("evaluate_scores", ["--scores", "{tmp}/missing.csv"]),
    ("cv_run", ["--config", "{cfg}", "--task", "rna"]),
    ("sweep", ["--config", "{cfg}", "--task", "rna", "--grid", '{{"lr_rna": [1e-4]}}']),
])
def test_evaluation_and_orchestration_clis_without_card_raise_unless_cpu_asked(
        name, argv, tmp_path, monkeypatch):
    """``cv_run`` and ``sweep`` pass ``--device`` to every child CLI, and
    raise before the first without a card."""
    import importlib

    main = importlib.import_module(f"multimodalbrainsurvival_torch.cli.{name}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.csv")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"cv_csv_path": missing, "train_csv_path": missing,
                               "val_csv_path": missing, "test_csv_path": missing,
                               "checkpoint_path": str(tmp_path / "ckpt")}))
    argv = [a.format(cfg=cfg, tmp=tmp_path) for a in argv]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
    # on the CPU it gets past the device to the missing input
    with pytest.raises(FileNotFoundError):
        main(argv + ["--device", "cpu"])


def test_validate_data_takes_no_device(tmp_path, monkeypatch):
    """No device work: it runs without a card, and ``--device`` is not a
    flag of it."""
    from multimodalbrainsurvival_torch.cli import validate_data

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"train_csv_path": str(tmp_path / "missing.csv")}))
    assert validate_data.main(["--config", str(cfg), "--task", "feature"]) == 1
    with pytest.raises(SystemExit):
        validate_data.main(["--config", str(cfg), "--task", "feature", "--device", "cpu"])


def test_late_fusion_without_card_raises_unless_cpu_asked(tmp_path, monkeypatch):
    from multimodalbrainsurvival_torch.cli import late_fusion

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.csv")
    with pytest.raises(RuntimeError, match="--device cpu"):
        late_fusion.main(["--train_csv", missing, "--val_csv", missing,
                          "--output_dir", str(tmp_path)])
    # on the CPU it gets as far as reading the frames
    with pytest.raises(FileNotFoundError):
        late_fusion.main(["--train_csv", missing, "--val_csv", missing,
                          "--output_dir", str(tmp_path), "--device", "cpu"])


def test_port_cli_modules_import_neither_pandas_nor_cv2():
    """The machine with the card has none of them: importing every module
    of the port (every CLI among them), in a fresh interpreter, leaves no
    ``pandas``, ``cv2``, ``PIL`` and ``openslide`` module behind."""
    import multimodalbrainsurvival_torch.cli as cli_pkg

    clis = [m.name for m in pkgutil.iter_modules(cli_pkg.__path__,
                                                 "multimodalbrainsurvival_torch.cli.")]
    for name in ("late_fusion", "merge_scores", "concat_features", "pack_patches",
                 "histo_train", "joint_train", "wsi2patches", "slide_extractfeatures",
                 "slide_joint_savescore", "attention_heatmap", "export_model", "serve",
                 "convert_checkpoint", "evaluate_scores", "validate_data", "cv_run", "sweep"):
        assert f"multimodalbrainsurvival_torch.cli.{name}" in clis
    modules = clis + [m.name for m in pkgutil.walk_packages(
        multimodalbrainsurvival_torch.__path__, "multimodalbrainsurvival_torch.")]
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('pandas', 'cv2', 'PIL', 'openslide'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_open_slide_reads_slides_without_openslide_pil_cv2_or_libtiff(tmp_path):
    """The machine with the card has no OpenSlide, Pillow, OpenCV or
    libtiff. In a fresh interpreter where the first three cannot be imported
    and the libtiff reader's build fails, ``open_slide`` reads the committed
    JPEG-tiled ``.svs`` and the two JPEG 2000-tiled ones (33003 and 33005,
    and the first one's thumbnail), classic and BigTIFF pyramids under
    none, LZW, deflate, PackBits and JPEG tiles, and a JPEG slide, to the
    pixels the JAX libtiff reader (with Pillow's OpenJPEG), libjpeg and
    OpenCV read here. The JAX reader is had through
    ``tests/_torch_jax_tiff.py``, steady when xdist workers build its
    library at once."""
    import hashlib

    import cv2

    from multimodalbrainsurvival_torch.data import tiff
    from multimodalbrainsurvival_torch.utils import native_tiff
    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    rng = np.random.default_rng(0)
    cells = np.repeat(np.repeat(rng.integers(0, 200, (14, 18, 3)), 16, 0), 16, 1)
    img = (cells[:200, :260] + rng.integers(0, 56, (200, 260, 3))).astype(np.uint8)
    want = {}
    for comp in (1, 5, 7, 8, 32773):
        classic, big = str(tmp_path / f"c{comp}.tif"), str(tmp_path / f"b{comp}.tif")
        b = native_tiff.SlideBuilder(classic)
        b.add_rgb_dir(img, tile=64, compression=comp)
        b.add_rgb_dir(img[::2, ::2], tile=64, compression=comp)
        b.close()
        with open(classic, "rb") as f:  # libtiff's blocks again, in a BigTIFF
            raw = f.read()
        tiff.write_tiff(big, [tiff.DirectorySpec(
            d.width, d.height, [raw[o:o + c] for o, c in zip(d.offsets, d.counts)],
            compression=d.compression, tile=d.tile, jpeg_tables=d.jpeg_tables)
            for d in tiff.read_directories(classic)], bigtiff=True)
        ref = jax_native_tiff_slide(classic)
        want[classic] = want[big] = [sha(ref.read_region((0, 0), i, size))
                                     for i, size in enumerate(ref.level_dimensions)]
    fixture = os.path.join(REPO, "tests", "data", "torch_tiff")
    with open(os.path.join(fixture, "fixture.json")) as f:
        meta = json.load(f)
    want[os.path.join(fixture, meta["slide"])] = [lv["sha256"] for lv in meta["levels"]]
    want_associated = {}
    for j2k in meta["j2k"]:
        path = os.path.join(fixture, j2k["slide"])
        want[path] = [lv["sha256"] for lv in j2k["levels"]]
        want_associated[path] = {k: v["sha256"] for k, v in j2k["associated"].items()}
    assert want_associated[os.path.join(fixture, "aperio_j2k.svs")].keys() == {"thumbnail"}
    jpg = str(tmp_path / "s.jpg")
    cv2.imwrite(jpg, img[:, :, ::-1])
    want[jpg] = [sha(cv2.imread(jpg)[:, :, ::-1])] * 2  # the image and its thumbnail
    code = textwrap.dedent(f"""
        import hashlib, importlib.abc, json, sys

        class Blocked(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] in ('openslide', 'PIL', 'cv2'):
                    raise ImportError(name + ' is not installed here')

        sys.meta_path.insert(0, Blocked())
        from multimodalbrainsurvival_torch.utils import native_tiff

        def no_libtiff(build_dir=None):
            raise RuntimeError('g++ failed: tiffio.h: No such file or directory')

        native_tiff.build = no_libtiff
        from multimodalbrainsurvival_torch.data import tiler
        out, associated = {{}}, {{}}
        for path in {sorted(want)!r}:
            slide = tiler.open_slide(path)
            out[path] = [hashlib.sha256(slide.read_region((0, 0), i, s).tobytes()).hexdigest()
                         for i, s in enumerate(slide.level_dimensions)]
            if path in {sorted(want_associated)!r}:
                associated[path] = {{k: hashlib.sha256(v.tobytes()).hexdigest()
                                    for k, v in slide.associated_images.items()}}
        print(json.dumps([out, associated]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [want, want_associated]


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
