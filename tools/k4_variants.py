"""Time variants of the fused-stage kernel (K4) against each other on the card.

Each variant is ``multimodalbrainsurvival_torch/kernels/csrc/fused_stage.cu``
with a few text substitutions, built by nvcc into the kernels' build
directory and loaded in place of the committed library. Every variant runs
both stage shapes of the main path (``chip_smoke.K4_STAGES``, 256 patches)
in bfloat16 and float32: checked against the plain version (a variant
that drops the products is wrong on purpose: it times the rest), then
timed with the L2 scrubbed, in turns (the variants in order, then
reversed). Run from the root of the repository, on a machine with a card:

    python tools/k4_variants.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from multimodalbrainsurvival_torch.kernels import build, fused_stage  # noqa: E402

VARIANTS = {
    "committed": [],
    "bf16_one_block": [("struct BlocksPerSM<bf16> { static constexpr int value = 2; }",
                        "struct BlocksPerSM<bf16> { static constexpr int value = 1; }")],
    "f32_two_blocks": [("struct BlocksPerSM<float> { static constexpr int value = 1; }",
                        "struct BlocksPerSM<float> { static constexpr int value = 2; }")],
    "k_chunks_64": [("constexpr int KC = 32;", "constexpr int KC = 64;")],
    "no_products": [
        ("    chunk_product(acc, it, ro, As + (c & 1) * a_stage, StagedA{c * KC},\n"
         "                  Bs + (c & 1) * b_stage, ldk, c * KC, K, grp, tig);\n", ""),
        ("    chunk_product(acc, it, ro, abase, asrc, Bs + (c & 1) * b_stage, ldk,\n"
         "                  c * KC, K, grp, tig);\n", ""),
    ],
}


def build_variant(name: str, patches) -> ctypes.CDLL:
    src = (build.CSRC / "fused_stage.cu").read_text()
    for old, new in patches:
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in the source")
        src = src.replace(old, new)
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True, check=True)
    print(name, " | ".join(line.strip() for line in (log.stdout + log.stderr).splitlines()
                           if "registers" in line or "spill" in line))
    lib = ctypes.CDLL(str(so))
    lib.fused_bottleneck_block.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_bottleneck_block.restype = ctypes.c_int
    lib.fused_bottleneck_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    chip_smoke.configure_precision()
    print(chip_smoke._nvidia_smi())
    libs = {name: build_variant(name, patches) for name, patches in VARIANTS.items()}
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
            fused_stage._lib = libs["committed"]
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
