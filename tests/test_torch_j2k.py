"""The port's JPEG 2000 decoder (``data/csrc/j2k.cc`` through
``data/codecs.py``) and the Aperio 33003 / 33005 levels of
``data/tiler.py::TiffSlide``, against Pillow (OpenJPEG 2.5) and the JAX
libtiff reader (``NativeTiffSlide``), on the CPU.

Codestreams are written by Pillow here from numpy-seeded images: reversible
(5/3) and irreversible (9/7), with and without a component transform, 1 to
6 resolutions, 64 x 64, 32 x 32 and 16 x 64 code-blocks, user precincts,
the five progression orders, quality layers under ``rates`` and ``dB``,
several tiles with tile and image offsets in one codestream, PLT markers,
sizes from 1 x 1 to 240 x 240 and 1, 3 and 4 components. Each case is held
twice: ``codecs.decode_j2k`` against Pillow's decode (and, for 33003,
Pillow's YCbCr → RGB, as the JAX reader converts), and a ``TiffSlide``
against the JAX ``NativeTiffSlide`` on a TIFF of those codestreams written
by the JAX ``SlideBuilder.add_raw_tiled_dir``, under 33003 and 33005.

Tolerance: none. Every case, the 9/7 ones included, is bit for bit the
reference's (the decoder keeps OpenJPEG's float32 steps in their order).
Corrupt codestreams are decoded in a subprocess, which must not crash:
every truncation raises ``DecodeError``, every bit flip raises it or
decodes. Each refused feature (markers, component formats, code-block
style bits) raises naming it, and through a slide naming the file, the
level and the tile. The tiler's artifacts on a 33003 slide equal the JAX
tiler's, and ``slide_extractfeatures`` reads a lossless 33005 slide to the
features of the same pixels uncompressed. Torch and the codecs run on 2
threads.
"""

import io
import json
import os
import struct
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st
from PIL import Image

from multimodalbrainsurvival_torch.cli import slide_extractfeatures, wsi2patches
from multimodalbrainsurvival_torch.data import codecs, tiff, tiler
from multimodalbrainsurvival_tpu.utils import native_tiff as jax_native_tiff
from tests._torch_jax_tiff import jax_native_tiff_slide, jax_tiff_library

torch.set_num_threads(2)
THREADS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YCBCR, RGB = tiff.APERIO_J2K_YCBCR, tiff.APERIO_J2K_RGB


@pytest.fixture(autouse=True)
def _codec_threads(monkeypatch):
    monkeypatch.setattr(codecs, "DEFAULT_THREADS", THREADS)


def _image(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    """8-px cells plus grain: every bit-plane carries data."""
    rng = np.random.default_rng(seed)
    cells = np.repeat(np.repeat(rng.integers(0, 200, (h // 8 + 1, w // 8 + 1, c)), 8, 0),
                      8, 1)[:h, :w]
    img = (cells + rng.integers(0, 56, (h, w, c))).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _encode(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", no_jp2=True, **kw)
    return buf.getvalue()


def _pillow(data: bytes, ycbcr: bool) -> np.ndarray:
    """The JAX reader's decode of one tile (``tiler.py::_decode_j2k_tile``)."""
    img = Image.open(io.BytesIO(data))
    if ycbcr:
        arr = np.asarray(img)
        if arr.ndim == 3 and arr.shape[2] == 3:
            img = Image.fromarray(arr, mode="YCbCr")
    return np.asarray(img.convert("RGB"))


# (name, (h, w, components), encoder options)
CASES = [
    ("reversible", (96, 112, 3), {}),
    ("irreversible", (96, 112, 3), dict(irreversible=True)),
    ("reversible_mct", (96, 112, 3), dict(mct=1)),
    ("irreversible_mct", (96, 112, 3), dict(irreversible=True, mct=1)),
    ("resolutions_1", (80, 72, 3), dict(num_resolutions=1, irreversible=True)),
    ("resolutions_3", (80, 72, 3), dict(num_resolutions=3)),
    ("resolutions_6", (240, 240, 3), dict(num_resolutions=6, irreversible=True)),
    ("blocks_32x32", (96, 112, 3), dict(codeblock_size=(32, 32), irreversible=True)),
    ("blocks_16x64", (96, 112, 3), dict(codeblock_size=(16, 64))),
    ("precincts", (120, 104, 3), dict(precinct_size=(32, 32), num_resolutions=4,
                                      irreversible=True)),
    ("LRCP", (120, 104, 3), dict(progression="LRCP", precinct_size=(32, 32),
                                 num_resolutions=4, quality_mode="rates",
                                 quality_layers=[30, 8])),
    ("RLCP", (120, 104, 3), dict(progression="RLCP", precinct_size=(32, 32),
                                 num_resolutions=4, quality_mode="rates",
                                 quality_layers=[30, 8])),
    ("RPCL", (120, 104, 3), dict(progression="RPCL", precinct_size=(32, 32),
                                 num_resolutions=4, irreversible=True)),
    ("PCRL", (120, 104, 3), dict(progression="PCRL", precinct_size=(64, 32),
                                 num_resolutions=4)),
    ("CPRL", (120, 104, 4), dict(progression="CPRL", precinct_size=(32, 64),
                                 num_resolutions=5, irreversible=True)),
    ("layers_rates", (96, 112, 3), dict(quality_mode="rates", quality_layers=[60, 20, 5])),
    ("layers_rates_irreversible", (96, 112, 3), dict(
        quality_mode="rates", quality_layers=[80, 24, 6], irreversible=True)),
    ("layers_dB", (96, 112, 3), dict(quality_mode="dB", quality_layers=[28, 36, 44],
                                     irreversible=True)),
    ("tiles_offsets", (100, 90, 3), dict(tile_size=(48, 40), tile_offset=(5, 7),
                                         offset=(9, 11), irreversible=True)),
    ("tiles_offsets_reversible", (100, 90, 3), dict(tile_size=(32, 48), tile_offset=(3, 1),
                                                    offset=(3, 6), num_resolutions=3)),
    ("plt", (96, 112, 3), dict(plt=True, quality_mode="rates", quality_layers=[40, 10])),
    ("size_1x1", (1, 1, 3), dict(irreversible=True)),
    ("size_17x33", (17, 33, 3), dict(irreversible=True, num_resolutions=3)),
    ("size_17x33_reversible", (17, 33, 3), dict(num_resolutions=4)),
    ("size_240x240", (240, 240, 3), dict(irreversible=True, quality_mode="rates",
                                         quality_layers=[24])),
    ("components_1", (64, 72, 1), dict(irreversible=True)),
    ("components_1_reversible", (64, 72, 1), {}),
    ("components_4", (64, 72, 4), dict(irreversible=True, mct=1)),
]


def _tiff_of(path: str, streams: list, tile: int, w: int, h: int, compression: int) -> None:
    """One level of ``streams`` (2 x 2 tiles of ``tile`` px) by the JAX
    libtiff writer."""
    jax_tiff_library()
    b = jax_native_tiff.SlideBuilder(path)
    b.add_raw_tiled_dir(w, h, tile, streams, compression, "Aperio|AppMag = 20|")
    b.close()


@pytest.mark.parametrize("compression", [YCBCR, RGB], ids=["33003", "33005"])
@pytest.mark.parametrize("name, shape, options", CASES, ids=[c[0] for c in CASES])
def test_codestreams_decode_as_pillow_and_the_jax_reader(tmp_path, name, shape, options,
                                                         compression):
    h, w, c = shape
    ycbcr = compression == YCBCR
    streams = [_encode(_image(100 * k + len(name), h, w, c), **options) for k in range(4)]
    for data in streams:
        np.testing.assert_array_equal(codecs.decode_j2k(data, ycbcr), _pillow(data, ycbcr))
    tile = max(16, -(-max(h, w) // 16) * 16)
    lw, lh = tile + max(1, w // 2), tile + max(1, h // 2)
    path = str(tmp_path / "s.svs")
    _tiff_of(path, streams, tile, lw, lh, compression)
    ours, theirs = tiler.TiffSlide(path), jax_native_tiff_slide(path)
    assert ours.level_dimensions == list(theirs.level_dimensions) == [(lw, lh)]
    for xy, size in (((0, 0), (lw, lh)), ((w // 2, h // 3), (tile, tile)),
                     ((lw - 5, lh - 3), (20, 20))):
        np.testing.assert_array_equal(ours.read_region(xy, 0, size),
                                      theirs.read_region(xy, 0, size))


@settings(max_examples=80, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.filter_too_much])
@given(h=st.integers(1, 90), w=st.integers(1, 90), c=st.sampled_from([1, 3, 4]),
       irreversible=st.booleans(), mct=st.integers(0, 1), resolutions=st.integers(1, 6),
       block=st.sampled_from([(64, 64), (32, 32), (16, 64), (64, 16), (8, 8), (4, 32)]),
       progression=st.sampled_from(["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]),
       precinct=st.sampled_from([None, 16, 32, 128]),
       layers=st.sampled_from([None, ("rates", [50, 12]), ("dB", [30, 42]),
                               ("rates", [90, 40, 10, 3])]),
       offset=st.tuples(st.integers(0, 7), st.integers(0, 7)), seed=st.integers(0, 999))
def test_random_codestreams_decode_as_pillow(h, w, c, irreversible, mct, resolutions, block,
                                             progression, precinct, layers, offset, seed):
    """Random encoder settings (derandomized: the same examples every run).
    Sizes are at least 2^resolutions a side, so that OpenJPEG's 9/7 encoder
    never meets a one-sample line (it aborts), and an image offset comes
    with a tile that holds the whole image (without one Pillow's encoder
    fails or crashes); settings the encoder refuses are not examples."""
    side = 1 << resolutions
    h, w = max(h, side), max(w, side)
    kw = dict(irreversible=irreversible, mct=mct, num_resolutions=resolutions,
              codeblock_size=block, progression=progression, offset=offset,
              tile_size=(w + offset[0], h + offset[1]))
    if precinct:
        kw["precinct_size"] = (precinct, precinct)
    if layers:
        kw["quality_mode"], kw["quality_layers"] = layers
    try:
        data = _encode(_image(seed, h, w, c), **kw)
    except OSError:
        assume(False)
    for ycbcr in (False, True):
        np.testing.assert_array_equal(codecs.decode_j2k(data, ycbcr), _pillow(data, ycbcr))


# --- markers Pillow does not write, refusals, corrupt streams ------------------------


def _main_segments(data: bytes) -> dict:
    """Main-header marker → offset of its marker code."""
    out, p = {}, 2
    while True:
        marker = struct.unpack(">H", data[p:p + 2])[0]
        if marker == 0xFF90:
            out[marker] = p
            return out
        out[marker] = p
        p += 2 + struct.unpack(">H", data[p + 2:p + 4])[0]


def _packet_lengths(data: bytes, plt_at: int) -> list:
    """The packet lengths of a PLT segment (7-bit groups, high bit: more)."""
    n = struct.unpack(">H", data[plt_at + 2:plt_at + 4])[0]
    out, v = [], 0
    for b in data[plt_at + 5:plt_at + 2 + n]:
        v = v << 7 | (b & 0x7F)
        if not b & 0x80:
            out.append(v)
            v = 0
    return out


def test_sop_markers_before_each_packet_are_read():
    """A stream with Scod's SOP bit and an SOP segment before every packet
    (placed by the PLT marker's lengths) decodes as the stream without."""
    img = _image(5, 96, 80)
    data = _encode(img, plt=True, num_resolutions=3, quality_mode="rates",
                   quality_layers=[30, 6], irreversible=True)
    seg = _main_segments(data)
    sot = seg[0xFF90]
    assert data[-2:] == b"\xff\xd9" and struct.unpack(">I", data[sot + 6:sot + 10])[0] in (
        0, len(data) - 2 - sot)
    q = sot + 12
    plt_at = None
    while data[q:q + 2] != b"\xff\x93":
        if data[q:q + 2] == b"\xff\x58":
            plt_at = q
        q += 2 + struct.unpack(">H", data[q + 2:q + 4])[0]
    lengths = _packet_lengths(data, plt_at)
    assert sum(lengths) == len(data) - 2 - (q + 2)
    body, p = bytearray(), q + 2
    for i, n in enumerate(lengths):
        body += b"\xff\x91\x00\x04" + struct.pack(">H", i % 65536) + data[p:p + n]
        p += n
    head = bytearray(data[:q + 2])
    cod = seg[0xFF52]
    head[cod + 4] |= 2
    struct.pack_into(">I", head, sot + 6, len(head) - sot + len(body))
    sop = bytes(head + body + b"\xff\xd9")
    np.testing.assert_array_equal(codecs.decode_j2k(sop), codecs.decode_j2k(data))
    np.testing.assert_array_equal(codecs.decode_j2k(sop), _pillow(data, False))


def _refused(kind: str, data: bytes) -> bytes:
    """``data`` changed to hold feature ``kind``."""
    seg = _main_segments(data)
    out = bytearray(data)
    siz, cod = seg[0xFF51], seg[0xFF52]
    after_siz = siz + 2 + struct.unpack(">H", data[siz + 2:siz + 4])[0]
    insert = {"POC": b"\xff\x5f\x00\x09" + bytes([0, 0, 0, 1, 6, 3, 0]),
              "RGN": b"\xff\x5e\x00\x05\x00\x00\x02",
              "PPM": b"\xff\x60\x00\x04\x00\x00",
              "marker": b"\xff\x74\x00\x04\x00\x00"}
    if kind in insert:
        return bytes(out[:after_siz] + insert[kind] + out[after_siz:])
    if kind == "PPT":  # into the tile-part header, Psot grown to match
        sot = seg[0xFF90]
        ppt = b"\xff\x61\x00\x04\x00\x00"
        psot = struct.unpack(">I", data[sot + 6:sot + 10])[0]
        if psot:
            struct.pack_into(">I", out, sot + 6, psot + len(ppt))
        return bytes(out[:sot + 12] + ppt + out[sot + 12:])
    if kind.startswith("style"):
        out[cod + 4 + 5 + 3] = int(kind[5:], 16)
    elif kind == "mct":
        out[cod + 4 + 4] = 2
    elif kind == "signed":
        out[siz + 4 + 36] |= 0x80
    elif kind == "precision":
        out[siz + 4 + 36] = 11
    elif kind == "subsampled":
        out[siz + 4 + 37 + 3] = 2  # component 1's XRsiz
    elif kind == "components":
        csiz = struct.unpack(">H", data[siz + 38:siz + 40])[0]
        out[siz + 38:siz + 40] = struct.pack(">H", 5)
        struct.pack_into(">H", out, siz + 2, 38 + 3 * 5)
        out[after_siz:after_siz] = b"\x07\x01\x01" * (5 - csiz)
    return bytes(out)


REFUSALS = {
    "POC": 19, "RGN": 20, "PPM": 21, "PPT": 22, "marker": 23, "signed": 24, "precision": 25,
    "subsampled": 26, "components": 27, "style01": 28, "style02": 29, "style04": 30,
    "style08": 31, "style10": 32, "style20": 33, "style40": 34, "mct": 35,
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refused_features_raise_naming_them(tmp_path, kind):
    """Through ``decode_j2k``, and through a slide: the file, the level,
    the tile and the feature."""
    code = REFUSALS[kind]
    good = _encode(_image(1, 64, 64), irreversible=True)
    bad = _refused(kind, good)
    feature = codecs.ERRORS[code]
    with pytest.raises(codecs.DecodeError, match=rf"cannot decode t\.j2c: .*\(code {code}\)"
                       ) as e:
        codecs.decode_j2k(bad, name="t.j2c")
    assert feature in str(e.value) and e.value.code == code
    path = str(tmp_path / "s.svs")
    tiff.write_tiff(path, [tiff.DirectorySpec(128, 64, [good, bad], compression=YCBCR,
                                              tile=(64, 64)),
                           tiff.image_directory(_image(2, 32, 64), tile=16)])
    slide = tiler.TiffSlide(path)
    slide.read_region((0, 0), 0, (64, 64))  # tile (0, 0) alone decodes
    with pytest.raises(codecs.DecodeError) as e:
        slide.read_region((60, 0), 0, (10, 10))
    assert (f"s.svs: level 0, tile (1, 0): cannot decode its Aperio JPEG 2000 (YCbCr) "
            f"data: {feature}") in str(e.value)


def test_corrupt_codestreams_raise_and_never_crash():
    """Truncations and single-bit flips of a layered, precinct-partitioned,
    multi-tile stream, decoded in a subprocess: every truncation raises
    ``DecodeError``, every flip raises it or gives an image of the shape."""
    data = _encode(_image(3, 120, 100), irreversible=True, num_resolutions=4,
                   precinct_size=(32, 32), tile_size=(64, 64), quality_mode="rates",
                   quality_layers=[40, 10], plt=True)
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        from multimodalbrainsurvival_torch.data import codecs
        data = bytes.fromhex({data.hex()!r})
        rng = np.random.default_rng(0)
        out = {{"truncated": [], "flipped": []}}
        for n in sorted(set(rng.integers(1, len(data) - 1, 40).tolist()) | {{1, 2, 40, 100}}):
            try:
                codecs.decode_j2k(data[:n])
                out["truncated"].append("decoded")
            except codecs.DecodeError as e:
                out["truncated"].append(e.code)
        for k in rng.integers(0, len(data) * 8, 160).tolist():
            bad = bytearray(data)
            bad[k // 8] ^= 1 << (k % 8)
            try:
                img = codecs.decode_j2k(bytes(bad))
                out["flipped"].append("decoded" if img.ndim == 3 else "bad shape")
            except codecs.DecodeError as e:
                out["flipped"].append(e.code)
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["truncated"]) >= 30 and "decoded" not in out["truncated"]
    assert set(out["truncated"]) <= set(codecs.ERRORS)
    assert len(out["flipped"]) == 160 and "bad shape" not in out["flipped"]
    assert set(out["flipped"]) - {"decoded"} <= set(codecs.ERRORS)
    assert "decoded" in out["flipped"] and len(set(out["flipped"])) > 1


# --- the tiler and the whole-slide CLI on J2K slides --------------------------------


def _tissue(seed: int, size: int = 512) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 255, np.uint8)
    noise = rng.integers(0, 60, size=(256, 320, 3), dtype=np.uint8)
    img[128:384, 64:384] = np.array([200, 120, 160], np.uint8) - noise // 2
    return img


def _j2k_level(img: np.ndarray, tile: int, compression: int, **kw) -> list:
    streams = []
    for y in range(0, img.shape[0], tile):
        for x in range(0, img.shape[1], tile):
            block = np.full((tile, tile, 3), 255, np.uint8)
            part = img[y:y + tile, x:x + tile]
            block[:part.shape[0], :part.shape[1]] = part
            if compression == YCBCR:
                block = np.asarray(Image.fromarray(block).convert("YCbCr"))
            streams.append(_encode(block, mct=0, **kw))
    return streams


def test_wsi2patches_on_a_j2k_slide_equals_the_jax_cli(tmp_path):
    """A 33003 slide (lossy 9/7, YCbCr samples, two levels): the port's
    ``wsi2patches`` writes the JAX CLI's ``loc.txt``, mask and patches."""
    from multimodalbrainsurvival_tpu.cli import wsi2patches as jax_wsi2patches

    img = _tissue(4)
    (tmp_path / "wsi").mkdir()
    path = str(tmp_path / "wsi" / "K1.svs")
    jax_tiff_library()
    b = jax_native_tiff.SlideBuilder(path)
    for level, px in enumerate((img, img[::4, ::4])):
        b.add_raw_tiled_dir(px.shape[1], px.shape[0], 128,
                            _j2k_level(px, 128, YCBCR, irreversible=True,
                                       quality_mode="rates", quality_layers=[20]),
                            YCBCR, "Aperio Image|AppMag = 20|" if level == 0 else "")
    b.close()
    common = ["--wsi_path", str(tmp_path / "wsi"), "--patch_size", "64",
              "--max_patches_per_slide", "12", "--num_process", "1", "--ext", "svs"]
    wsi2patches.main(common + ["--patch_path", str(tmp_path / "p"), "--mask_path",
                               str(tmp_path / "m"), "--device", "cpu"])
    jax_wsi2patches.main(common + ["--patch_path", str(tmp_path / "jp"), "--mask_path",
                                   str(tmp_path / "jm")])
    ours, theirs = tmp_path / "p" / "K1", tmp_path / "jp" / "K1"
    assert (ours / "loc.txt").read_text() == (theirs / "loc.txt").read_text()
    np.testing.assert_array_equal(np.load(tmp_path / "m" / "K1" / "mask.npy"),
                                  np.load(tmp_path / "jm" / "K1" / "mask.npy"))
    n = len((ours / "loc.txt").read_text().splitlines()) - 2
    assert n == 12
    for i in range(n):
        np.testing.assert_array_equal(tiler.read_png(str(ours / f"K1_patch_{i}.png")),
                                      cv2.imread(str(theirs / f"K1_patch_{i}.png"))[:, :, ::-1])


def test_slide_extractfeatures_reads_a_lossless_j2k_slide_as_its_pixels(tmp_path):
    """The same pixels in reversible 33005 tiles and in uncompressed ones:
    ``slide_extractfeatures`` gives the same patches, scores and features."""
    from multimodalbrainsurvival_torch.cli.histo_train import build_mil_model
    from multimodalbrainsurvival_torch.config import Config

    img = _tissue(6)
    paths = {}
    for kind in ("j2k", "raw"):
        (tmp_path / kind).mkdir()
        paths[kind] = str(tmp_path / kind / "L1.svs")
        levels = []
        for level, px in enumerate((img, img[::4, ::4])):
            desc = "Aperio Image|AppMag = 20|" if level == 0 else ""
            if kind == "j2k":
                levels.append(tiff.DirectorySpec(px.shape[1], px.shape[0],
                                                 _j2k_level(px, 128, RGB), compression=RGB,
                                                 tile=(128, 128), description=desc))
            else:
                levels.append(tiff.image_directory(px, tile=128, description=desc))
        tiff.write_tiff(paths[kind], levels)
    cfg = {"model_name": "resnet18", "num_classes": 1, "aggregator_hdim": 512,
           "img_size": 64, "batch_size": 8, "max_patches_per_slide": 8,
           "compute_dtype": "float32", "aggregator": "attention", "save_patch_features": True}
    torch.manual_seed(0)
    torch.save(build_mil_model(Config(cfg)).state_dict(), str(tmp_path / "mil.pt"))
    for kind, path in paths.items():
        c = dict(cfg, slides=[path], model_path=str(tmp_path / "mil.pt"),
                 output_path=str(tmp_path / f"out_{kind}"))
        (tmp_path / f"{kind}.json").write_text(json.dumps(c))
        slide_extractfeatures.main(["--config", str(tmp_path / f"{kind}.json"),
                                    "--device", "cpu"])
    j2k, raw = tmp_path / "out_j2k", tmp_path / "out_raw"
    assert (j2k / "slide_scores.csv").read_text() == (raw / "slide_scores.csv").read_text()
    assert ((j2k / "patch_features" / "L1_patches.csv").read_text()
            == (raw / "patch_features" / "L1_patches.csv").read_text())
    np.testing.assert_array_equal(np.load(j2k / "patch_features" / "L1_features.npy"),
                                  np.load(raw / "patch_features" / "L1_features.npy"))


def test_the_committed_j2k_fixtures_decode_to_the_jax_digests():
    """``tests/data/torch_tiff/aperio_j2k{,_rgb}.svs``: every level and the
    thumbnail at the JAX reader's digests (``fixture.json``), and the JAX
    reader still reads those digests here."""
    import hashlib

    fixture = os.path.join(REPO, "tests", "data", "torch_tiff")
    with open(os.path.join(fixture, "fixture.json")) as f:
        meta = json.load(f)
    assert [j["compression"] for j in meta["j2k"]] == [YCBCR, RGB]

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for j in meta["j2k"]:
        path = os.path.join(fixture, j["slide"])
        ours, theirs = tiler.open_slide(path), jax_native_tiff_slide(path)
        assert ours.level_dimensions == [tuple(lv["size"]) for lv in j["levels"]]
        for level, lv in enumerate(j["levels"]):
            size = tuple(lv["size"])
            assert sha(ours.read_region((0, 0), level, size)) == lv["sha256"]
            assert sha(theirs.read_region((0, 0), level, size)) == lv["sha256"]
        assert sorted(ours.associated_images) == sorted(j["associated"])
        for name, a in j["associated"].items():
            assert sha(ours.associated_images[name]) == a["sha256"]
            assert sha(np.asarray(theirs.associated_images[name].convert("RGB"))) == a["sha256"]
