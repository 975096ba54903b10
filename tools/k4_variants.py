"""Time variants of the fused-stage kernel (K4) against each other on the card.

Each variant is ``multimodalbrainsurvival_torch/kernels/csrc/fused_stage.cu``
with a few text substitutions (the knobs of the bfloat16 wgmma path: ring
depth, output channels per pass, two fixed tiles; ``wait_0``, no wgmma group
left in flight; ``sync_chunks``, that and a barrier over both consumer
warpgroups before every chunk, the schedule of a kernel without the
producer/consumer split; and a variant without the products that times the
rest), built by nvcc into the kernels' build directory and loaded in place
of the committed library. With ``--parent DIR``, DIR's ``fused_stage.cu``
and ``qmm_requant.cu`` (the sources of an earlier commit, unpacked with
``git archive``) are built as the variant ``parent`` of K4, and of K3 beside
the committed K3; ``--k4 NAME=FILE`` adds another K4 source as variant NAME.
A source from elsewhere includes the headers beside it first (an earlier
``hopper.cuh``), then the committed ones.
Every variant runs both stage shapes of the main path
(``chip_smoke.K4_STAGES``, 256 patches) in bfloat16 (float32, whose FMA path
no variant changes, only for ``committed`` and ``parent``), and K3 the seven
shapes of ``chip_smoke.K3_SHAPES``: checked against the plain version (the
variant without products is wrong on purpose), then timed with the L2
scrubbed, in turns (the variants in order, then reversed). Run from the root
of the repository, on a machine with a card:

    python tools/k4_variants.py [--parent DIR] [--k4 NAME=FILE ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from multimodalbrainsurvival_torch.kernels import (  # noqa: E402
    build,
    fused_stage,
    qmm_requant,
)

VARIANTS = {
    "committed": [],
    "ring_2": [("constexpr int MAX_STAGES = 4;", "constexpr int MAX_STAGES = 2;")],
    "ring_3": [("constexpr int MAX_STAGES = 4;", "constexpr int MAX_STAGES = 3;")],
    "pass_64": [("constexpr int NB = 128;  ", "constexpr int NB = 64;  ")],
    "tile_8x14": [("    for (int TW = 1; TW <= W && TH * TW <= 128; ++TW) {\n"
                   "      Plan l;",
                   "    for (int TW = 1; TW <= W && TH * TW <= 128; ++TW) {\n"
                   "      if (TH != 8 || TW != 14) continue;\n"
                   "      Plan l;")],
    "tile_4x32": [("    for (int TW = 1; TW <= W && TH * TW <= 128; ++TW) {\n"
                   "      Plan l;",
                   "    for (int TW = 1; TW <= W && TH * TW <= 128; ++TW) {\n"
                   "      if (TH != 4 || TW != 32) continue;\n"
                   "      Plan l;")],
    "wait_0": [("hopper::wgmma_wait<1>();", "hopper::wgmma_wait<0>();")],
    "sync_chunks": [("hopper::wgmma_wait<1>();", "hopper::wgmma_wait<0>();"),
                    ("    hopper::mbar_wait(&full[it % S], (it / S) & 1);\n",
                     "    consumer_sync();\n"
                     "    hopper::mbar_wait(&full[it % S], (it / S) & 1);\n")],
    "no_products": [("hopper::wgmma_bf16_ss_n64(acc[t]", "if (0) hopper::wgmma_bf16_ss_n64(acc[t]"),
                    ("hopper::wgmma_bf16_rs_n64(acc[t]", "if (0) hopper::wgmma_bf16_rs_n64(acc[t]")],
}


def build_source(name: str, src: str, home: Path = build.CSRC) -> ctypes.CDLL:
    """Build ``src`` as ``lib<name>.so``; its includes are found in ``home``
    (the directory it came from) first, then in the committed ``csrc/``."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(home), "-I",
                          str(build.CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log.stdout}{log.stderr}")
    print(name, " | ".join(line.strip() for line in (log.stdout + log.stderr).splitlines()
                           if "registers" in line or "spill" in line)[:600])
    return ctypes.CDLL(str(so))


def k4_library(name: str, src: str, home: Path = build.CSRC) -> ctypes.CDLL:
    lib = build_source(name, src, home)
    lib.fused_bottleneck_block.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_bottleneck_block.restype = ctypes.c_int
    lib.fused_bottleneck_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def k4_variants(parent: Path | None, extra: dict[str, Path]) -> dict:
    committed = (build.CSRC / "fused_stage.cu").read_text()
    libs = {}
    for name, patches in VARIANTS.items():
        src = committed
        for old, new in patches:
            if old not in src:
                raise ValueError(f"{name}: {old!r} is not in the source")
            src = src.replace(old, new)
        libs[name] = k4_library(name, src)
    if parent is not None:
        libs["parent"] = k4_library("parent", (parent / "fused_stage.cu").read_text(),
                                    parent)
    for name, path in extra.items():
        libs[name] = k4_library(name, path.read_text(), path.parent)
    device = torch.device("cuda")
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = {}
    for where, batch, cin, H, W, cm, n_blocks in chip_smoke.K4_STAGES:
        modules, x32 = chip_smoke._k4_stage(batch, cin, H, W, cm, n_blocks, g, device)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            packed = [fused_stage.pack_bottleneck(m, dtype) for m in modules]
            runs = {}
            for name, lib in libs.items():
                if dtype == torch.float32 and name not in ("committed", "parent"):
                    continue
                plans = []
                for blk in packed:  # a variant whose shared memory overflows skips
                    plan = (ctypes.c_int * 5)()
                    if lib.fused_bottleneck_plan(fused_stage._DTYPE_CODES[dtype], H, W,
                                                 blk.w1.shape[1], cm, blk.w3.shape[0],
                                                 int(blk.wd is not None), plan) == 0:
                        plans.append(list(plan))
                if len(plans) == len(packed):
                    runs[name] = plans[-1]
            key = f"{where} {str(dtype)[6:]}"
            times = {name: [] for name in runs}
            errs = {}
            with torch.inference_mode():
                want = fused_stage.fused_bottleneck_stage_plain(x, packed)
                for name in list(runs) + list(runs)[::-1]:
                    fused_stage._lib = libs[name]
                    out = fused_stage.fused_bottleneck_stage(x, packed)
                    torch.cuda.synchronize()
                    errs[name] = (out.float() - want.float()).abs().max().item()
                    times[name].append(chip_smoke._time_ms(
                        lambda: fused_stage.fused_bottleneck_stage(x, packed),
                        5 if dtype == torch.bfloat16 else 2, scrub))
            results[key] = {name: {"ms": sum(t) / len(t), "max_abs_err": errs[name],
                                   "plan_last_block": runs[name]}
                            for name, t in times.items()}
            print(key, json.dumps(results[key]), flush=True)
            fused_stage._lib = None
    return results


def k3_against_parent(parent: Path) -> dict:
    """The committed K3 and the parent's at ``chip_smoke.K3_SHAPES`` (relu on),
    identical outputs required of both, timed in turns."""
    libs = {"committed": qmm_requant._library(),
            "parent": build_source("parent_qmm_requant",
                                   (parent / "qmm_requant.cu").read_text(), parent)}
    libs["parent"].qconv_requant_s8.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    libs["parent"].qconv_requant_s8.restype = ctypes.c_int
    device = torch.device("cuda")
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = {}
    for where, batch, H, W, C, N, k, stride, pad in chip_smoke.K3_SHAPES:
        x, w, scale, bias = chip_smoke._k3_inputs(batch, H, W, C, N, k, g, device)
        conv = dict(stride=stride, padding=pad)
        want = qmm_requant.qconv_requant_plain(x, w, scale, bias, **conv)
        times = {name: [] for name in libs}
        mismatches = {}
        for name in list(libs) + list(libs)[::-1]:
            qmm_requant._lib = libs[name]
            out = qmm_requant.qconv_requant(x, w, scale, bias, **conv)
            torch.cuda.synchronize()
            mismatches[name] = int((out != want).sum())
            times[name].append(chip_smoke._time_ms(
                lambda: qmm_requant.qconv_requant(x, w, scale, bias, **conv), 25, scrub))
        qmm_requant._lib = libs["committed"]
        results[where] = {name: {"ms": sum(t) / len(t), "mismatches": mismatches[name]}
                          for name, t in times.items()}
        print(f"K3 {where}", json.dumps(results[where]), flush=True)
        del x, w, want
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="csrc/ of an earlier commit: its K4 and K3 are timed too")
    parser.add_argument("--k4", action="append", default=[], metavar="NAME=FILE",
                        help="another fused_stage.cu to time as variant NAME")
    args = parser.parse_args()
    extra = {name: Path(path) for name, path in (v.split("=", 1) for v in args.k4)}
    if not torch.cuda.is_available():
        print("k4_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    chip_smoke.configure_precision()
    print(chip_smoke._nvidia_smi())
    results = {"k4": k4_variants(args.parent, extra)}
    if args.parent is not None:
        results["k3"] = k3_against_parent(args.parent)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
