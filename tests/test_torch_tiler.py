"""The port's tiler (``data/tiler.py``, ``data/opencv_compat.py``,
``utils/native_tiff.py``, ``cli/wsi2patches.py``) against the JAX tiler and
OpenCV, on the CPU.

Inputs are numpy-seeded synthetic slides (``tests/test_slide_extract.py``'s
recipe: a noisy tissue rectangle on white). Tolerances: none. Tile
positions, their order, the masks and the pixels are equal; the OpenCV
reproductions equal ``cv2`` on every case here (the 2x INTER_LINEAR
downscale the tiler uses, other downscales, INTER_AREA at integer and
fractional factors, the grey conversion, the viridis table).
"""

import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
import torch

from multimodalbrainsurvival_torch.cli import attention_heatmap, wsi2patches
from multimodalbrainsurvival_torch.data import opencv_compat, tiler
from multimodalbrainsurvival_torch.utils import native_tiff
from multimodalbrainsurvival_tpu.data import tiler as jax_tiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slide(seed: int, size: int = 512, tissue=((128, 384), (64, 384)),
           color=(200, 120, 160)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 255, np.uint8)
    (y0, y1), (x0, x1) = tissue
    noise = rng.integers(0, 60, size=(y1 - y0, x1 - x0, 3), dtype=np.uint8)
    img[y0:y1, x0:x1] = np.array(color, np.uint8) - noise // 2
    return img


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    """A 20x PNG slide and an AppMag-40 two-level tiled TIFF pyramid
    (written by the port's writer), each under its own directory."""
    root = tmp_path_factory.mktemp("tiler")
    png_dir, tif_dir = root / "png", root / "tif"
    png_dir.mkdir()
    tif_dir.mkdir()
    cv2.imwrite(str(png_dir / "S1.png"), _slide(0)[:, :, ::-1])
    big = _slide(1, size=1024, tissue=((256, 768), (128, 768)), color=(190, 110, 170))
    native_tiff.write_test_pyramid(str(tif_dir / "T1.tif"), [big, big[::4, ::4]], tile=128,
                                   description="Aperio Image|AppMag = 40|MPP = 0.25")
    return {"png": str(png_dir / "S1.png"), "tif": str(tif_dir / "T1.tif"),
            "png_dir": str(png_dir), "tif_dir": str(tif_dir), "big": big}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primitives_equal_the_jax_tiler(seed):
    rng = np.random.default_rng(seed)
    img = _slide(seed, size=96, tissue=((20, 80), (10, 70)))
    img[::7] = rng.integers(0, 256, img[::7].shape, dtype=np.uint8)
    assert tiler.otsu_threshold(img[..., 0]) == jax_tiler.otsu_threshold(img[..., 0])
    sat = tiler.rgb_to_saturation(img)
    np.testing.assert_array_equal(sat, jax_tiler.rgb_to_saturation(img))
    assert tiler.otsu_threshold(sat) == jax_tiler.otsu_threshold(sat)
    np.testing.assert_array_equal(tiler.tissue_mask(img), jax_tiler.tissue_mask(img))
    for lo, hi in ((100, 105), (100, 120), (0, 255)):
        flat = rng.integers(lo, hi + 1, (32, 32, 3), dtype=np.uint8)
        assert tiler.is_low_contrast(flat) == jax_tiler.is_low_contrast(flat)


def test_grey_conversion_equals_opencv():
    img = np.random.default_rng(3).integers(0, 256, (97, 131, 3), dtype=np.uint8)
    np.testing.assert_array_equal(opencv_compat.rgb_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("src, dst", [((448, 448), (224, 224)), ((128, 96), (64, 48)),
                                      ((97, 131), (70, 100)), ((97, 131), (40, 60))])
def test_linear_resize_equals_opencv(src, dst):
    """The tiler's 2x downscale (AppMag 40 at dezoom 1) and other downscales."""
    img = np.random.default_rng(4).integers(0, 256, (*src, 3), dtype=np.uint8)
    size = (dst[1], dst[0])
    np.testing.assert_array_equal(opencv_compat.resize_linear(img, size),
                                  cv2.resize(img, size, interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("src, dst", [((120, 90), (40, 30)), ((120, 90), (60, 45)),
                                      ((97, 131), (48, 65)), ((97, 131), (9, 13)),
                                      ((1024, 1024), (200, 200))])
def test_area_resize_equals_opencv(src, dst):
    img = np.random.default_rng(5).integers(0, 256, (*src, 3), dtype=np.uint8)
    size = (dst[1], dst[0])
    np.testing.assert_array_equal(opencv_compat.resize_area(img, size),
                                  cv2.resize(img, size, interpolation=cv2.INTER_AREA))


def test_viridis_table_equals_opencv():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8).reshape(1, 256),
                            cv2.COLORMAP_VIRIDIS)[0][:, ::-1]
    np.testing.assert_array_equal(attention_heatmap.VIRIDIS, lut)


@pytest.mark.parametrize("kind", ["png", "tif"])
def test_tiles_equal_the_jax_tiler(slides, kind):
    """Same candidate order, accepted positions and pixels (the TIFF at
    AppMag 40: 128-px reads downscaled to 64)."""
    ours, theirs = tiler.open_slide(slides[kind]), jax_tiler.open_slide(slides[kind])
    assert ours.level_dimensions == list(theirs.level_dimensions)
    cfg, jcfg = tiler.TileConfig(patch_size=64), jax_tiler.TileConfig(patch_size=64)
    mask = tiler.compute_tissue_mask(ours, cfg)
    np.testing.assert_array_equal(mask, jax_tiler.compute_tissue_mask(theirs, jcfg))
    assert tiler.read_size_for(ours, cfg) == jax_tiler.read_size_for(theirs, jcfg)
    np.testing.assert_array_equal(tiler.candidate_positions(ours, mask, cfg),
                                  jax_tiler.candidate_positions(theirs, mask, jcfg))
    got = list(tiler.iter_tissue_patches(ours, cfg, mask=mask))
    want = list(jax_tiler.iter_tissue_patches(theirs, jcfg, mask=mask))
    assert len(got) == len(want) > 4
    for (i, x, y, p), (j, xx, yy, pp) in zip(got, want):
        assert (i, x, y) == (j, xx, yy)
        np.testing.assert_array_equal(p, pp)


def test_native_reader_reads_the_written_pyramid(slides):
    slide = tiler.open_slide(slides["tif"])
    assert isinstance(slide, tiler.TiffSlide)
    assert slide.properties["aperio.AppMag"] == "40"
    big = slides["big"]
    np.testing.assert_array_equal(slide.read_region((100, 200), 0, (150, 70)),
                                  big[200:270, 100:250])
    np.testing.assert_array_equal(slide.read_region((0, 0), 1, (256, 256)), big[::4, ::4])


@pytest.mark.parametrize("kind", ["png", "tif"])
def test_wsi2patches_equals_the_jax_cli(slides, tmp_path, kind):
    from multimodalbrainsurvival_tpu.cli import wsi2patches as jax_wsi2patches

    common = ["--wsi_path", slides[f"{kind}_dir"], "--patch_size", "64",
              "--max_patches_per_slide", "12", "--num_process", "1", "--ext", kind]
    wsi2patches.main(common + ["--patch_path", str(tmp_path / "p"), "--mask_path",
                               str(tmp_path / "m"), "--device", "cpu"])
    jax_wsi2patches.main(common + ["--patch_path", str(tmp_path / "jp"), "--mask_path",
                                   str(tmp_path / "jm")])
    sid = "S1" if kind == "png" else "T1"
    ours, theirs = tmp_path / "p" / sid, tmp_path / "jp" / sid
    assert (ours / "loc.txt").read_text() == (theirs / "loc.txt").read_text()
    np.testing.assert_array_equal(np.load(tmp_path / "m" / sid / "mask.npy"),
                                  np.load(tmp_path / "jm" / sid / "mask.npy"))
    n = len((ours / "loc.txt").read_text().splitlines()) - 2
    assert n == 12
    for i in range(n):
        got = tiler.read_png(str(ours / f"{sid}_patch_{i}.png"))
        want = cv2.imread(str(theirs / f"{sid}_patch_{i}.png"))[:, :, ::-1]
        np.testing.assert_array_equal(got, want)
        # OpenCV decodes the port's PNG to the same pixels
        np.testing.assert_array_equal(cv2.imread(str(ours / f"{sid}_patch_{i}.png"))[:, :, ::-1],
                                      want)


def test_open_slide_raises_naming_an_unread_format(tmp_path):
    path = tmp_path / "s.bmp"
    cv2.imwrite(str(path), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match=r"\.bmp"):
        tiler.open_slide(str(path))


def test_a_single_level_tiff_is_an_image_slide(tmp_path):
    img = _slide(5, size=256, tissue=((64, 192), (64, 192)))
    path = str(tmp_path / "one.tif")
    native_tiff.write_test_pyramid(path, [img], tile=0)
    slide = tiler.open_slide(path)
    assert isinstance(slide, tiler.ImageSlide)
    np.testing.assert_array_equal(slide.img, img)


def test_wsi2patches_without_card_raises_unless_cpu_asked(slides, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        wsi2patches.main(["--wsi_path", slides["png_dir"], "--patch_path", str(tmp_path),
                          "--mask_path", str(tmp_path), "--ext", "png"])


def test_four_processes_build_the_tiff_reader_at_once(tmp_path):
    build_dir = tmp_path / "build"
    img = _slide(6, size=128, tissue=((32, 96), (32, 96)))
    path = str(tmp_path / "s.tif")
    code = textwrap.dedent(f"""
        import numpy as np, os
        from pathlib import Path
        from multimodalbrainsurvival_torch.utils import native_tiff
        native_tiff.BUILD_DIR = Path({str(build_dir)!r})
        lib = native_tiff.load(Path({str(build_dir)!r}))
        print(lib.tiff_builder_open.restype is not None)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "True"
    assert sorted(os.listdir(build_dir)) == [native_tiff.library_path(build_dir).name]
    native_tiff.write_test_pyramid(path, [img, img[::2, ::2]], tile=64)
    np.testing.assert_array_equal(tiler.open_slide(path).read_region((0, 0), 0, (128, 128)),
                                  img)


def test_a_failed_tiff_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "tiff_slide.cc"
    broken.write_text("int tiff_slide_open( {\n")
    monkeypatch.setattr(native_tiff, "SOURCE", broken)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*: error:"):
        native_tiff.build(tmp_path / "build")
    assert not any((tmp_path / "build").iterdir())


def test_associated_images_of_an_svs_layout(tmp_path):
    """``SlideBuilder``'s Aperio layout: tiled levels are the pyramid, the
    stripped directories its associated images, named as the JAX reader
    names them."""
    img = _slide(7, size=256, tissue=((64, 192), (64, 192)))
    label = np.full((40, 60, 3), 90, np.uint8)
    path = str(tmp_path / "s.svs")
    b = native_tiff.SlideBuilder(path)
    b.add_rgb_dir(img, tile=64, description="Aperio Image|AppMag = 20")
    b.add_rgb_dir(img[::4, ::4], tile=0, description="thumb")
    b.add_rgb_dir(img[::2, ::2], tile=64)
    b.add_rgb_dir(label, tile=0, description="label 640x480")
    b.close()
    slide = tiler.open_slide(path)
    assert slide.level_dimensions == [(256, 256), (128, 128)]
    assert slide.properties["aperio.AppMag"] == "20"
    assoc = slide.associated_images
    assert sorted(assoc) == ["label", "thumbnail"]
    np.testing.assert_array_equal(assoc["label"], label)
    np.testing.assert_array_equal(assoc["thumbnail"], img[::4, ::4])
    np.testing.assert_array_equal(slide.read_region((64, 32), 1, (50, 40)),
                                  img[::2, ::2][16:56, 32:82])
