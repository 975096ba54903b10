"""Time variants of the port's kernels (K1, K2a, K2b, K3, K4) against each
other on the card.

K1 (the attention pool) and K2a (the seeded dropout-matmul) share their
product, ``multimodalbrainsurvival_torch/kernels/csrc/splitk_tn.cuh``. Its
variants are text substitutions in that header, in ``hopper.cuh`` and in
the committed ``attention_pool.cu`` and ``dropout_matmul.cu``:
``split_<n>`` (n blocks
along K, in place of the planned split), ``lag_0`` (bfloat16: no wgmma
group left in flight), ``ring_3`` (bfloat16: 3 ring stages instead of 6),
``no_pdl`` (K1: the softmax-and-pool launch queued after the projection
ends, not scheduled while it runs),
``ahead_less_1`` (loads one k-tile less ahead), ``l2_prefetch_128``
(float32: each cp.async piece asks L2 to fetch its whole 128-byte line),
``no_flush`` (float32: the
tensor cores' accumulator carried over every k-tile, no IEEE sum in
registers), ``b_hi_raw`` (float32: the weight's tf32 hi part left as the
float32 value, for the tensor cores to cut), and two that compute something
else, to time what is left without a part: ``no_split_pass`` (float32: no
mask and no hi/lo split in shared memory), ``no_products``, and for K1 in
bfloat16 ``no_pool_launch`` (no softmax-and-pool launch),
``no_cluster_sum`` (no sum over the cluster and no epilogue) and
``no_loads`` (no TMA loads: the products read whatever the ring holds). With
``--parent DIR`` the parent's ``attention_pool.cu`` and
``dropout_matmul.cu`` are built as the variant ``parent``. K1 runs at the
main path's shape (``chip_smoke.k1_inputs``) in bfloat16 and float32, K2a
at both RNA layers (``chip_smoke.K2_SHAPES``, drop probability 0.5, and
at 0, no mask, for ``committed`` and ``parent``); each
variant is checked against the plain version (its error is printed, never
enforced: ``no_flush`` is there to measure it), then all are timed with the
L2 scrubbed, in turns (the variants in order, then reversed). All nvcc
builds of this part start together.

K2b's variants (``K2B_VARIANTS``: the 64-bit division per element, the
row's mask key not hoisted out of the column loop, 8-byte
pieces in place of a scalar head at dense_0, pieces in flight, threads a
block, grid size, cache hints, programmatic launch, no mask, an empty
launch) are substitutions in the committed ``dropout_matmul.cu``; with ``--parent DIR`` DIR's ``dropout_matmul.cu`` is
built as ``parent``. The single form runs at both RNA layers, the paired
form at dense_1's shape against two launches of the committed single form,
two of the parent's and two ``torch.mul`` calls by the pre-scaled mask;
each is checked against the plain version and timed in turns, with its
speed-up over the parent.

The ``k2`` part holds K2 against its parent in both dtypes: K2a (float32
at the RNA batch, bf16 at the joint model's 128 rows) and K2b's single
and paired forms at both RNA layers, the committed kernels, K2b's
``unhoisted`` variant (each value's mask key computed from its row) and
the parent's, every output equal to the committed one's, timed in turns
``--rounds`` times (``--only k2 --parent DIR``).

K4's variants are ``multimodalbrainsurvival_torch/kernels/csrc/fused_stage.cu``
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
scrubbed, in turns (the variants in order, then reversed). ``--only``
picks the parts to run (default all). Run from the root of the repository,
on a machine with a card:

    python tools/kernel_variants.py [--parent DIR] [--k4 NAME=FILE ...]
        [--only k1_k2a,k2b,k2,k4,k3] [--rounds N]
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
    attention_pool,
    build,
    dropout_matmul,
    fused_stage,
    qmm_requant,
)

SPLIT = "const int want = plan_split(kernel, bytes, tiles_m * tiles_n, p.nkt, resident);"
SPLITK_VARIANTS = {
    "committed": [],
    **{f"split_{n}": [(SPLIT, f"const int want = {n} < p.nkt ? {n} : p.nkt;")]
       for n in (1, 2, 3, 4, 8)},
    "lag_0": [("  static constexpr int LAG = 1;", "  static constexpr int LAG = 0;")],
    "ring_3": [("  static constexpr int STAGES = 6;", "  static constexpr int STAGES = 3;")],
    "l2_prefetch_128": [("cp.async.ca.shared.global [%0]",
                         "cp.async.ca.shared.global.L2::128B [%0]")],
    "no_pdl": [("attr.val.programmaticStreamSerializationAllowed = 1;",
                "attr.val.programmaticStreamSerializationAllowed = 0;")],
    "ahead_less_1": [("  constexpr int AHEAD = S - LAG;", "  constexpr int AHEAD = S - LAG - 1;")],
    "no_flush": [("ks != 0)", "1)"),
                 ("for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);",
                  "for (int i = 0; i < BN / 2; ++i) sum[i] = acc[i];")],
    "b_hi_raw": [("        *hi = h;\n", "        if (is_a) *hi = h;\n")],
    "no_split_pass": [("        if (is_a) Epi::transform(ep, v, m0 + q / 8, k0 + 4 * (q % 8));\n",
                       "        continue;\n")],
    "no_pool_launch": [("  err = cudaLaunchKernelEx(&cfg, softmax_pool_kernel<T>,",
                        "  if (0) err = cudaLaunchKernelEx(&cfg, softmax_pool_kernel<T>,")],
    "no_cluster_sum": [("  for (int row = rb + tid / 32; row < re; row += THREADS / 32) {",
                        "  for (int row = re; row < re; row += THREADS / 32) {")],
    "no_loads": [("        mbar_arrive_expect_tx(bar, 2 * TILE);\n"
                  "        tma_load_2d(stage, &amap, bar, k0, m0);\n"
                  "        tma_load_2d(stage + TILE, &bmap, bar, k0, n0);\n",
                  "        mbar_arrive(bar);\n")],
    "no_products": [("wgmma_tf32_ss_n128(acc,", "if (0) wgmma_tf32_ss_n128(acc,"),
                    ("wgmma_bf16_ss_n128(acc,", "if (0) wgmma_bf16_ss_n128(acc,")],
}
# the dtype a variant changes (K2a is float32); the others run in every dtype
SPLITK_DTYPE = {"no_flush": torch.float32, "l2_prefetch_128": torch.float32,
                "b_hi_raw": torch.float32, "no_split_pass": torch.float32,
                "lag_0": torch.bfloat16, "ring_3": torch.bfloat16, "no_pdl": torch.bfloat16,
                "no_pool_launch": torch.bfloat16, "no_cluster_sum": torch.bfloat16,
                "no_loads": torch.bfloat16}

# K2b's variants: substitutions in dropout_matmul.cu. ``div64`` takes each
# element's (row, col) from a 64-bit i / K and i % K, as the first K2b did,
# with everything else as committed; ``pieces_8`` takes 8-byte pieces where
# rows alternate between 16- and 8-byte alignment (dense_0) in place of a
# scalar head before 16-byte pieces; ``ilp_<n>`` loads n pieces a thread
# before hashing (committed: 4); ``threads_<n>``, n threads a block
# (committed: 256); ``load_default`` loads without the streaming hint;
# ``store_cs`` also stores with it (evict-first); ``pdl`` launches with
# programmatic stream serialization; ``grid_half`` and ``grid_eighth`` launch
# that share of one wave's blocks; ``l2_256`` asks L2 to fetch 256 bytes
# for each 16-byte load; ``no_hash`` (no mask) and ``empty`` (a launch that
# does nothing) compute something else, to size the rest.
STORE_CS = ("  *reinterpret_cast<Piece<T, V>*>(p) = v;\n",
            "  using W = typename Word<sizeof(T) * V>::type;\n"
            "  W w;\n"
            "  memcpy(&w, &v, sizeof(W));\n"
            "  __stcs(reinterpret_cast<W*>(p), w);\n")
K2B_LOAD = "  const W w = __ldcs(reinterpret_cast<const W*>(p));\n"
K2B_LAUNCH = ("  seeded_dropout_kernel<T, V, PAIR>\n"
              "      <<<dim3(gx, gy), K2B_THREADS, 0, stream>>>(a, b, out_a, out_b, M, K, mask);\n")
K2B_VARIANTS = {
    "committed": [],
    "div64": [("            const bool kept = keep_key(key + col + e, mask);\n",
               "            const long long i = static_cast<long long>(row) * K + col + e;\n"
               "            const bool kept = keep(static_cast<uint32_t>(i / K),\n"
               "                                   static_cast<uint32_t>(i % K), mask);\n")],
    "pieces_8": [("  const int v = PAIR ? piece_width<T>({a, b, out_a, out_b}) : "
                  "piece_width<T>({a, out_a});\n",
                  "  int v = PAIR ? piece_width<T>({a, b, out_a, out_b}) : "
                  "piece_width<T>({a, out_a});\n"
                  "  if (sizeof(T) == 4 && v == 4 && K % 4) v = 2;\n")],
    **{f"ilp_{n}": [("constexpr int K2B_ILP = 4;", f"constexpr int K2B_ILP = {n};")]
       for n in (1, 2)},
    **{f"threads_{n}": [("constexpr int K2B_THREADS = 256;", f"constexpr int K2B_THREADS = {n};")]
       for n in (128, 512)},
    "load_default": [(K2B_LOAD, "  const W w = *reinterpret_cast<const W*>(p);\n")],
    "store_cs": [STORE_CS],
    "pdl": [("  const int step = K2B_THREADS * gridDim.x;\n",
             "  hopper::pdl_wait();\n  const int step = K2B_THREADS * gridDim.x;\n"),
            (K2B_LAUNCH,
             "  cudaLaunchConfig_t cfg = {};\n"
             "  cfg.gridDim = dim3(gx, gy);\n"
             "  cfg.blockDim = dim3(K2B_THREADS);\n"
             "  cfg.stream = stream;\n"
             "  cudaLaunchAttribute attr;\n"
             "  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
             "  attr.val.programmaticStreamSerializationAllowed = 1;\n"
             "  cfg.attrs = &attr;\n"
             "  cfg.numAttrs = 1;\n"
             "  cudaLaunchKernelEx(&cfg, seeded_dropout_kernel<T, V, PAIR>, a, b, out_a, out_b, M,\n"
             "                     K, mask);\n")],
    "grid_half": [("  int gy = resident / gx;\n", "  int gy = resident / gx / 2;\n")],
    "grid_eighth": [("  int gy = resident / gx;\n", "  int gy = resident / gx / 8;\n")],
    "l2_256": [(K2B_LOAD,
                "  W w;\n"
                "  if constexpr (sizeof(W) == 16)\n"
                "    asm volatile(\"ld.global.cs.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
                "                 : \"=r\"(w.x), \"=r\"(w.y), \"=r\"(w.z), \"=r\"(w.w) : \"l\"(p));\n"
                "  else\n"
                "    w = __ldcs(reinterpret_cast<const W*>(p));\n")],
    # each value's key from its row, the row's key not hoisted out of the
    # column loop (as before the mask offsets)
    "unhoisted": [("            const bool kept = keep_key(key + col + e, mask);\n",
                   "            const bool kept = keep(row, col + e, mask);\n"),
                  ("        const bool kept = keep_key(key + col, mask);\n",
                   "        const bool kept = keep(row, col, mask);\n")],
    "no_hash": [("            const bool kept = keep_key(key + col + e, mask);\n",
                 "            const bool kept = true;\n")],
    "empty": [("  const int step = K2B_THREADS * gridDim.x;\n",
               "  const int step = K2B_THREADS * gridDim.x;\n  if (M > 0) return;\n")],
}
# K2's C entries, which take the mask offsets (row0, col0) before the stream
K2_ENTRIES = tuple(f"{entry}_{suffix}" for entry in ("dropout_matmul", "seeded_dropout",
                                                      "seeded_dropout_pair")
                   for suffix in ("f32", "bf16"))

# K4's variants: substitutions in fused_stage.cu
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


def patched(src: str, patches: list, name: str) -> str:
    for old, new in patches:
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in the source")
        src = src.replace(old, new)
    return src


def build_sources(jobs: dict) -> dict:
    """Build every ``jobs[key] = (cu_path, source, home)`` at once, one nvcc
    each, as ``lib<stem>.so`` beside ``cu_path``; a quoted include is found
    beside ``cu_path`` first, then in ``home`` (the directory the source
    came from), then in the committed ``csrc/``. Returns each library."""
    procs = {}
    for key, (cu, src, home) in jobs.items():
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        so = cu.with_name(f"lib{cu.stem}.so")
        procs[key] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(home), "-I", str(build.CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        print(key, " | ".join(line.strip() for line in log.splitlines()
                              if "registers" in line or "spill" in line)[:600])
        libs[key] = ctypes.CDLL(str(so))
    return libs


def build_source(name: str, src: str, home: Path = build.CSRC) -> ctypes.CDLL:
    """Build ``src`` as ``lib<name>.so``; its includes are found in ``home``
    (the directory it came from) first, then in the committed ``csrc/``."""
    cu = build.BUILD_DIR / "variants" / f"{name}.cu"
    return build_sources({name: (cu, src, home)})[name]


SPLITK_FILES = ("splitk_tn.cuh", "hopper.cuh", "attention_pool.cu", "dropout_matmul.cu")


def splitk_variant_sources(name: str) -> dict:
    """{file: text} of variant ``name``: its substitutions applied to the
    committed files of ``SPLITK_FILES`` wherever their text occurs (each
    somewhere)."""
    out = {f: (build.CSRC / f).read_text() for f in SPLITK_FILES}
    for old, new in SPLITK_VARIANTS[name]:
        hits = [f for f in SPLITK_FILES if old in out[f]]
        if not hits:
            raise ValueError(f"{name}: {old!r} is in none of {SPLITK_FILES}")
        for f in hits:
            out[f] = out[f].replace(old, new)
    return out


def splitk_libraries(parent: Path | None) -> dict:
    """{variant: {"attention_pool": lib, "dropout_matmul": lib}}, bound."""
    jobs = {}
    for name in SPLITK_VARIANTS:
        home = build.BUILD_DIR / "variants" / name
        home.mkdir(parents=True, exist_ok=True)
        out = splitk_variant_sources(name)
        for f in ("splitk_tn.cuh", "hopper.cuh"):
            (home / f).write_text(out[f])
        for src in ("attention_pool", "dropout_matmul"):
            jobs[(name, src)] = (home / f"{src}.cu", out[f"{src}.cu"], home)
    if parent is not None:
        for src in ("attention_pool", "dropout_matmul"):
            jobs[("parent", src)] = (build.BUILD_DIR / "variants" / "parent" / f"{src}.cu",
                                     (parent / f"{src}.cu").read_text(), parent)
    libs = {}
    for (name, src), lib in build_sources(jobs).items():
        if src == "attention_pool":
            bind = attention_pool.bind
        else:
            bind = bind_parent_dropout if name == "parent" else dropout_matmul.bind
        libs.setdefault(name, {})[src] = bind(lib)
    return libs


class _WithoutOffsets:
    """A parent's dropout_matmul library from before the mask offsets,
    called through the committed wrapper: each K2 entry drops the offsets
    ``(row0, col0)`` (only offset-free calls may reach it)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in K2_ENTRIES:
            return fn

        def call(*args):
            *head, row0, col0, stream = args
            if row0 or col0:
                raise ValueError("the parent's K2 takes no mask offsets")
            return fn(*head, stream)

        return call


def bind_parent_dropout(lib: ctypes.CDLL) -> _WithoutOffsets:
    """A parent's dropout_matmul library: K2's entries as they were before
    the mask offsets (the committed ones without ``row0, col0``)."""
    dropout_matmul.bind(lib)
    for name in K2_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = fn.argtypes[:-3] + fn.argtypes[-1:]
    return _WithoutOffsets(lib)


def _in_turns(names: list, run, timed, rounds: int = 1) -> dict:
    """``run(name)`` → error once per name, ``timed(name)`` → ms twice per
    name and round (the names in order, then reversed)."""
    times = {name: [] for name in names}
    errs = {}
    for name in (names + names[::-1]) * rounds:
        if name not in errs:
            errs[name] = run(name)
        times[name].append(timed(name))
    return {name: {"ms": sum(t) / len(t), "max_abs_err": errs[name]}
            for name, t in times.items()}


def k1_k2a_variants(parent: Path | None) -> dict:
    """K1 at the main path's shape in both dtypes and K2a at both RNA layers,
    every variant of ``splitk_tn.cuh`` and the parent's kernels, checked
    against the plain versions and timed in turns."""
    libs = splitk_libraries(parent)
    device = torch.device("cuda")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = {}
    x32, w32, v, mask = chip_smoke.k1_inputs(device)
    for dtype in (torch.bfloat16, torch.float32):
        x, w = x32.to(dtype), w32.to(dtype)
        want = attention_pool.attention_pool_plain(x, w, v, mask)
        names = [n for n in libs if SPLITK_DTYPE.get(n, dtype) == dtype]

        def run(name):
            attention_pool._lib = libs[name]["attention_pool"]
            got = attention_pool.attention_pool(x, w, v, mask)
            torch.cuda.synchronize()
            return max((a - b).abs().max().item() for a, b in zip(got, want))

        def timed(name):
            attention_pool._lib = libs[name]["attention_pool"]
            return chip_smoke._time_ms(lambda: attention_pool.attention_pool(x, w, v, mask),
                                       25, scrub)

        key = f"K1 {chip_smoke.B}x{chip_smoke.BAG}x{chip_smoke.D} {str(dtype)[6:]}"
        results[key] = _in_turns(names, run, timed)
        print(key, json.dumps(results[key]), flush=True)
    attention_pool._lib = None
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    seed = 20240607
    runs = [(where, M, K, N, p) for where, M, K, N in chip_smoke.K2_SHAPES
            for p in (chip_smoke.RNA_DROPOUT, 0.0)]
    for where, M, K, N, p in runs:
        names = [n for n in libs if SPLITK_DTYPE.get(n, torch.float32) == torch.float32
                 and (p > 0 or n in ("committed", "parent"))]
        x = torch.randn(M, K, generator=g).to(device)
        w = (torch.randn(N, K, generator=g) / K**0.5).to(device)
        want = dropout_matmul.dropout_matmul_plain(x, w, seed, p)

        def run(name):
            dropout_matmul._lib = libs[name]["dropout_matmul"]
            got = dropout_matmul.dropout_matmul(x, w, seed, p)
            torch.cuda.synchronize()
            return (got - want).abs().max().item()

        def timed(name):
            dropout_matmul._lib = libs[name]["dropout_matmul"]
            return chip_smoke._time_ms(lambda: dropout_matmul.dropout_matmul(x, w, seed, p),
                                       10 if K > 8192 else 25, scrub)

        key = f"K2a {where} {M}x{K}x{N} p={p}"
        results[key] = _in_turns(names, run, timed)
        print(key, json.dumps(results[key]), flush=True)
        del x, w, want
    dropout_matmul._lib = None
    return results


def k2b_variants(parent: Path | None) -> dict:
    """K2b's single form at both RNA layers and its paired form at dense_1's
    (drop probability 0.5), every variant of ``K2B_VARIANTS``, the parent's
    kernel (twice, against the pair) and ``torch.mul`` by the pre-scaled mask
    (twice, against the pair), each checked against the plain version and
    timed in turns."""
    committed = (build.CSRC / "dropout_matmul.cu").read_text()
    jobs = {name: (build.BUILD_DIR / "variants" / f"k2b_{name}" / "dropout_matmul.cu",
                   patched(committed, patches, name), build.CSRC)
            for name, patches in K2B_VARIANTS.items()}
    if parent is not None:
        jobs["parent"] = (build.BUILD_DIR / "variants" / "k2b_parent" / "dropout_matmul.cu",
                          (parent / "dropout_matmul.cu").read_text(), parent)
    libs = {name: (bind_parent_dropout if name == "parent" else dropout_matmul.bind)(lib)
            for name, lib in build_sources(jobs).items()}
    device = torch.device("cuda")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    seed, p = 20240607, chip_smoke.RNA_DROPOUT
    results = {}

    def ours(name, fn, *args):
        dropout_matmul._lib = libs[name]
        return fn(*args, seed, p)

    for where, M, K, _ in chip_smoke.K2_SHAPES:
        x = torch.randn(M, K, generator=g).to(device)
        want = dropout_matmul.seeded_dropout_plain(x, seed, p)
        mask = dropout_matmul.keep_mask(M, K, seed, p, device).float() * float(
            dropout_matmul.keep_scale(p))
        calls = {name: (lambda name=name: ours(name, dropout_matmul.seeded_dropout, x))
                 for name in K2B_VARIANTS}
        if parent is not None:
            calls["parent"] = lambda: ours("parent", dropout_matmul.seeded_dropout, x)
        calls["torch.mul"] = lambda: torch.mul(x, mask)
        # not a yardstick of the function: a copy of the same bytes
        calls["clone"] = lambda: x.clone()
        label = f"K2b {where} {M}x{K} p={p}"
        results[label] = _k2b_in_turns(label, calls, [want], scrub)
        if where == "dense_1":
            b = torch.randn(M, K, generator=g).to(device)
            want2 = [want, dropout_matmul.seeded_dropout_plain(b, seed, p)]
            pairs = {f"{name} pair": (lambda name=name: ours(
                name, dropout_matmul.seeded_dropout_pair, x, b)) for name in K2B_VARIANTS}
            pairs["committed x2"] = lambda: (ours("committed", dropout_matmul.seeded_dropout, x),
                                             ours("committed", dropout_matmul.seeded_dropout, b))
            if parent is not None:
                pairs["parent pair"] = lambda: ours("parent", dropout_matmul.seeded_dropout_pair,
                                                    x, b)
            pairs["torch.mul x2"] = lambda: (torch.mul(x, mask), torch.mul(b, mask))
            label = f"K2b pair {where} {M}x{K} p={p}"
            results[label] = _k2b_in_turns(label, pairs, want2, scrub)
        del x, want, mask
    dropout_matmul._lib = None
    return results


def _k2b_in_turns(label: str, calls: dict, want: list, scrub: torch.Tensor) -> dict:
    """Each call's outputs against ``want`` and its time, in turns; with the
    parent among the calls, each one's speed-up over it."""
    def run(name):
        got = calls[name]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    out = _in_turns(list(calls), run, lambda name: chip_smoke._time_ms(calls[name], 25, scrub))
    ref = next((r["ms"] for n, r in out.items() if n.startswith("parent")), None)
    if ref is not None:
        for rec in out.values():
            rec["parent_over_this"] = ref / rec["ms"]
    print(label, json.dumps(out), flush=True)
    return out


def k2_against_parent(parent: Path | None, rounds: int) -> dict:
    """K2a (float32 at the RNA batch, bf16 at the joint model's 128 rows)
    and K2b's single and paired forms in both dtypes, at both RNA layers
    (drop probability 0.5): the committed kernels, K2b's ``unhoisted``
    variant and, with ``--parent``, the parent's, each output equal to the
    committed kernel's bit for bit, timed in turns ``rounds`` times; each
    one's time over the parent's."""
    committed = (build.CSRC / "dropout_matmul.cu").read_text()
    jobs = {"unhoisted": (build.BUILD_DIR / "variants" / "k2_unhoisted" / "dropout_matmul.cu",
                          patched(committed, K2B_VARIANTS["unhoisted"], "unhoisted"),
                          build.CSRC)}
    if parent is not None:
        jobs["parent"] = (build.BUILD_DIR / "variants" / "k2_parent" / "dropout_matmul.cu",
                          (parent / "dropout_matmul.cu").read_text(), parent)
    built = build_sources(jobs)
    libs = {"committed": dropout_matmul._library(),
            "unhoisted": dropout_matmul.bind(built["unhoisted"])}
    if parent is not None:
        libs["parent"] = bind_parent_dropout(built["parent"])
    device = torch.device("cuda")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    seed, p = 20240607, chip_smoke.RNA_DROPOUT
    results = {}
    for dtype, M in ((torch.float32, chip_smoke.RNA_BATCH), (torch.bfloat16, 128)):
        for where, _, K, N in chip_smoke.K2_SHAPES:
            x = torch.randn(M, K, generator=g).to(device, dtype)
            b = torch.randn(M, K, generator=g).to(device, dtype)
            w = (torch.randn(N, K, generator=g) / K**0.5).to(device, dtype)
            forms = {
                f"K2a {where} {M}x{K}x{N}": (lambda: dropout_matmul.dropout_matmul(
                    x, w, seed, p), ["committed", "parent"]),
                f"K2b {where} {M}x{K}": (lambda: dropout_matmul.seeded_dropout(x, seed, p),
                                         ["committed", "unhoisted", "parent"]),
                f"K2b pair {where} {M}x{K}": (lambda: dropout_matmul.seeded_dropout_pair(
                    x, b, seed, p), ["committed", "unhoisted", "parent"]),
            }
            for label, (fn, names) in forms.items():
                names = [n for n in names if n in libs]

                def call(name, fn=fn):
                    dropout_matmul._lib = libs[name]
                    out = fn()
                    return out if isinstance(out, tuple) else (out,)

                want = call("committed")

                def run(name, call=call, want=want):
                    got = call(name)
                    torch.cuda.synchronize()
                    return max((u.float() - v.float()).abs().max().item()
                               for u, v in zip(got, want))

                def timed(name, fn=fn):
                    dropout_matmul._lib = libs[name]
                    return chip_smoke._time_ms(fn, 10 if K > 8192 else 25, scrub)

                label = f"{label} {str(dtype)[6:]}"
                out = _in_turns(names, run, timed, rounds)
                if "parent" in out:
                    for rec in out.values():
                        rec["over_parent"] = rec["ms"] / out["parent"]["ms"]
                results[label] = out
                print(label, json.dumps(out), flush=True)
                bad = {n: r["max_abs_err"] for n, r in out.items() if r["max_abs_err"]}
                if bad:
                    raise AssertionError(f"{label}: outputs differ from the committed "
                                         f"kernel's: {bad}")
            del x, b, w
    dropout_matmul._lib = None
    return results


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
        libs[name] = k4_library(name, patched(committed, patches, name))
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
                        help="csrc/ of an earlier commit: its K1, K2a, K4 and K3 are "
                             "timed too")
    parser.add_argument("--k4", action="append", default=[], metavar="NAME=FILE",
                        help="another fused_stage.cu to time as variant NAME")
    parser.add_argument("--only", default="k1_k2a,k2b,k2,k4,k3",
                        help="comma-separated parts to run: k1_k2a, k2b, k2, k4, k3 (k3 "
                             "needs --parent)")
    parser.add_argument("--rounds", type=int, default=4,
                        help="rounds of turns of the k2 part")
    args = parser.parse_args()
    extra = {name: Path(path) for name, path in (v.split("=", 1) for v in args.k4)}
    parts = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    chip_smoke.configure_precision()
    print(chip_smoke._nvidia_smi())
    results = {}
    if "k1_k2a" in parts:
        results["k1_k2a"] = k1_k2a_variants(args.parent)
    if "k2b" in parts:
        results["k2b"] = k2b_variants(args.parent)
    if "k2" in parts:
        results["k2"] = k2_against_parent(args.parent, args.rounds)
    if "k4" in parts:
        results["k4"] = k4_variants(args.parent, extra)
    if "k3" in parts and args.parent is not None:
        results["k3"] = k3_against_parent(args.parent)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
