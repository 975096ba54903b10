"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

Run from the root of the repository, on a machine with a card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, one nvcc per source, in parallel;
   each kernel's registers, shared memory and spills as ptxas reports them;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (the attention pool in float32, 3xTF32 against
   the plain version's float32 with TF32 off, and in bfloat16, within
   ``KERNEL_TOL``; the int8 product K3 at seven shapes
   of ResNet-50 at 256 patches, relu on and off, identical int8, and in its
   residual form at the conv3 shapes of layers 1-4 (identity and projection
   skips), and the int8 stem pass at 224 px and 225 px, identical int8,
   timed beside the sequences they replace; K2a, the
   seeded dropout-matmul, at both RNA layer shapes within ``K2A_TOL``, and
   K2b, the seeded dropout alone, identical, at both shapes and in its
   paired form, two tensors under one mask, at dense_1's), then timed with
   CUDA events,
   L2 scrubbed before each launch and every launch queued behind a sleep
   kernel (so the host's time to prepare it is not timed), in turns with
   the plain version and a one-call PyTorch yardstick; K4, the fused
   folded-BN bottleneck stage, at layer1's and layer2's stride-1 tail's
   shapes at 256 patches in
   bfloat16 and float32 within ``K4_TOL``, timed against the same stage
   through cuDNN; the pool's gradient (its ``autograd.Function``: K1
   forward, the analytic backward in plain PyTorch) against autograd of
   the plain version at 16 x 16 x 2048 and 128 x 2 x 2048 (padded) and
   128 x 1 x 2048 (there dW = dv = 0: checked to be 0) in both dtypes
   within ``K1_GRAD_TOL``, forward + backward and the backward alone
   timed beside the plain version's autograd;
4. main path: a synthetic cohort (8 slides x 64 patches at 224 px, packed
   shards, made from a seed) through the port's ``histo_savescore`` and
   ``histo_extractfeatures`` at ResNet-50 / attention 2048 / bfloat16 on
   ``cuda``, first in floating point, then with ``quantize: "int8"``, then
   with ``fold_bn: true`` (the folded encoder, its layer1 and layer2 tail
   through K4); for each path the launch counters are set to 0 just before
   and read just after, and the CSVs are checked. On one batch: the pooled
   embedding through the pool kernel against its plain version; the int8
   bag embeddings against the float ones (cosine); the int8 features of 32
   patches through K3 and the stem pass against the same forward through
   their plain versions (bit for bit); the folded bag embeddings against the
   unfolded ones
   (cosine); the bf16, int8 and folded encoders' device time, and the
   attention pool's (K1) share of the bf16 batch's device time;
5. reference: a small cohort through ``histo_savescore`` in float32 on the
   card and on the CPU (plain versions), unfolded and with ``fold_bn:
   true`` (K4 in float32 on the card); the scores must agree;
6. RNA path: a synthetic 12,778-gene cohort (train 1,024 / val 256 / test
   256, from a seed) through ``rna_train`` (2 epochs, batch 256, dropout
   0.5, float32 at the reference width), then ``rna_savescore`` and
   ``rna_extractfeatures`` on its ``model_last.pt``; the counters are set
   to 0 just before and read just after each CLI, and every frame is
   checked. Then one train step's device time (CUDA events) and profile,
   with K2a's share of the step and the card's idle share taken from K2a's
   own timing in phase 3 (the profiler drops some K2a records);
7. RNA reference: two dropout-free train steps of a small 12,778-gene
   cohort on the card and on the CPU from one seeded init; the val scores
   must agree;
8. histo train path: ``histo_train`` on the main path's cohort at
   ResNet-50 / attention 2048 / bfloat16 / 224 px (batch 16, bags of 16,
   ``n_layers_to_train`` 2, flips and jitter on, 2 epochs, Adam at 5e-4),
   ``histo_savescore`` on its ``model_last.pt``, then ``histo_train`` with
   ``quantize_trunk: "int8"`` for an epoch; the counters are set to 0 just
   before and read just after each CLI (K1 once a train step and an eval
   batch, its backward once a train step, K3 on the frozen trunk) and
   every frame is checked. Then one train step's device time, idle share
   and K1's share at ``n_layers_to_train`` 2 and 6;
9. histo train reference: two float32 train steps of a small cohort
   (augmentation off, the whole network) on the card and on the CPU from
   one seeded init; the val scores must agree.

The last lines are the ``kernels`` JSON line, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from multimodalbrainsurvival_torch.cli import (
    histo_extractfeatures,
    histo_savescore,
    histo_train,
    rna_extractfeatures,
    rna_savescore,
    rna_train,
)
from multimodalbrainsurvival_torch.cli._common import (
    build_datasets,
    build_mil_model,
    load_mil_model,
    serving_adapter,
    tune_optimizer,
)
from multimodalbrainsurvival_torch.cli.rna_train import build_rna_model, build_rna_optimizer
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import RNATableDataset
from multimodalbrainsurvival_torch.device import configure_precision
from multimodalbrainsurvival_torch.kernels import build
from multimodalbrainsurvival_torch.kernels.attention_pool import (
    attention_pool,
    attention_pool_backward,
    attention_pool_plain,
    pool,
)
from multimodalbrainsurvival_torch.kernels.dropout_matmul import (
    dropout_matmul,
    dropout_matmul_plain,
    keep_mask,
    keep_scale,
    seeded_dropout,
    seeded_dropout_pair,
    seeded_dropout_pair_plain,
    seeded_dropout_plain,
)
from multimodalbrainsurvival_torch.kernels.fused_stage import (
    fused_block_plan,
    fused_bottleneck_stage,
    fused_bottleneck_stage_plain,
    pack_bottleneck,
)
from multimodalbrainsurvival_torch.kernels.qmm_requant import (
    im2col,
    qconv_requant,
    qconv_requant_plain,
    qconv_residual_requant,
    qconv_residual_requant_plain,
    qmm_requant,
    residual_relu_q,
    stem_requant_pool,
    stem_requant_pool_plain,
)
from multimodalbrainsurvival_torch.models import quantize, serving
from multimodalbrainsurvival_torch.models.resnet import Bottleneck
from multimodalbrainsurvival_torch.models.rna import RNA_GENES
from multimodalbrainsurvival_torch.train import TrainSettings
from multimodalbrainsurvival_torch.train.adapters import MILAdapter, TableAdapter
from multimodalbrainsurvival_torch.train.loop import make_loss_fn, train_step
from multimodalbrainsurvival_torch.train.optim import (
    build_grouped_optimizer,
    mil_freeze_ladder,
    wrap_optimizer,
)

SEED = 0
# the main path's shape at the aggregator: 16 bags x 16 patches x 2048
B, BAG, D = 16, 16, 2048
N_WSI, N_PATCH, IMG = 8, 64, 224
# kernel vs plain: the same inputs, float32 sums in another order; the
# softmax amplifies the rounding of the logits
KERNEL_TOL = 2e-4
# H100 SXM peaks (NVIDIA data sheet, dense): memory, bf16 tensor, f32 FMA,
# int8 tensor, TF32 tensor
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
# a sleep kernel's length in clock cycles (≈50 ms at the H100's 1.98 GHz):
# long enough for the host to queue every timed launch behind it
SLEEP_CYCLES = 100_000_000
# K3 at the main path's shapes, 256 patches at 224 px:
# (where, batch, H, W, C, N, kernel, stride, pad) of the NHWC conv
K3_SHAPES = (
    ("layer1 conv3 / downsample", 256, 56, 56, 64, 256, 1, 1, 0),
    ("layer2 conv3", 256, 28, 28, 128, 512, 1, 1, 0),
    ("layer3 conv3", 256, 14, 14, 256, 1024, 1, 1, 0),
    ("layer4 conv3", 256, 7, 7, 512, 2048, 1, 1, 0),
    ("layer4_0 conv1", 256, 14, 14, 1024, 512, 1, 1, 0),
    ("layer1 conv2 (3x3)", 256, 56, 56, 64, 64, 3, 1, 1),
    ("layer2_0 conv2 (3x3, stride 2)", 256, 56, 56, 128, 128, 3, 2, 1),
)
# ResNet-50: 16 blocks x 3 convs + 4 downsamples, every one through K3; the
# last conv of each block in K3's residual form; one stem pass
K3_LAUNCHES_PER_BATCH = 52
K3_RESIDUAL_PER_BATCH = 16
STEM_PER_BATCH = 1
# K3's residual form at the conv3 shapes of layers 1-4, 256 patches:
# (where, batch, H, W, C, N, projection); a projection skip is the
# downsample conv's int8 output (K3), an identity skip the block's input
K3_RESIDUAL_SHAPES = (
    ("layer1_0 conv3, projection skip", 256, 56, 56, 64, 256, True),
    ("layer1 conv3, identity skip", 256, 56, 56, 64, 256, False),
    ("layer2 conv3", 256, 28, 28, 128, 512, False),
    ("layer3 conv3", 256, 14, 14, 256, 1024, False),
    ("layer4 conv3", 256, 7, 7, 512, 2048, False),
)
# the stem pass on the float32 stem conv output (where, batch, C, H, W):
# 256 patches at 224 px, and an odd size (225 px) with a ragged pool edge
STEM_SHAPES = (("224 px", 256, 64, 112, 112), ("225 px", 16, 64, 113, 113))
# the JAX package's contract for quantize: "int8" (tests/test_quantize.py)
INT8_COSINE = 0.995
# the RNA path: 12,778 genes -> 4,096 -> 2,048 -> 1 in float32, batches of
# 256, dropout 0.5, 2 epochs over a synthetic cohort made from SEED
RNA_BATCH, RNA_EPOCHS, RNA_DROPOUT = 256, 2, 0.5
RNA_SPLITS = {"train": 1024, "val": 256, "test": 256}
# K2a vs plain (cuBLAS SGEMM, TF32 off): the same masked operands, float32
# sums over up to 12,778 terms in another order, outputs of order 1
K2A_TOL = 1e-4
# (where, M, K, N) of K2a on the RNA path: both Dropout -> Linear pairs
K2_SHAPES = (("dense_0", RNA_BATCH, RNA_GENES, 4096), ("dense_1", RNA_BATCH, 4096, 2048))
# per train step: K2a once per layer; K2b's single form on dense_0's x for
# dW (its input is data, with no dx), its paired form on dense_1's g·W (dx)
# and x (dW) in one launch
K2A_PER_STEP, K2B_PER_STEP, K2B_PAIR_PER_STEP = 2, 1, 1
# K4 at the main path's stage shapes, 256 patches at 224 px: (where, batch,
# Cin, H, W, Cm, blocks); Cout = 4 Cm, block 0 projects when Cin != Cout
K4_STAGES = (("layer1", 256, 64, 56, 56, 64, 3),
             ("layer2 tail", 256, 512, 28, 28, 128, 3))
# K4 vs plain, err / max(1, max|plain|): float32 sums in another order;
# in bfloat16 both round y1, y2, z and the sum, and a sum on the other side
# of a rounding moves an output by 1-2 ulps (2**-8 of its size each)
K4_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-6}
# per batch of a folded Bottleneck ResNet: layer1's 3 blocks and layer2's
# 3 stride-1 blocks, one launch each
K4_LAUNCHES_PER_BATCH = 6
# folded vs unfolded bf16 bag embeddings (both bf16, rounded at other places)
FOLDED_COSINE = 0.999
# K1's gradient through the Function (kernel forward, analytic backward)
# against autograd of the plain version, err / max|plain gradient|: float32
# sums in another order (3xTF32 forward in float32); in bfloat16 both read
# the same bf16 x and W, so only the kernel's float32 logits differ
K1_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-7}
# K1's gradient shapes: the main path's 16 bags x 16 patches (one short bag,
# one padded sample) and the reference's batch 128 x bag 1
K1_GRAD_SHAPES = (("16x16x2048, padded", 16, 16), ("128x2x2048, padded", 128, 2),
                  ("128x1x2048", 128, 1))
# the histo train path (phase 8): the reference's Adam LR, the freeze ladder
# at 2 (layer4 and the head train) and the whole network
HISTO_LR, HISTO_EPOCHS = 5e-4, 2
# ResNet-50's stem and first three stages under quantize_trunk at
# n_layers_to_train 2: 13 blocks x 3 convs + 3 downsamples through K3, the
# last conv of each block in its residual form, one stem pass
K3_TRUNK_PER_BATCH, K3_TRUNK_RESIDUAL_PER_BATCH = 42, 13
COUNTERS = {"attention_pool": attention_pool, "qmm_requant": qmm_requant,
            "qconv_residual_requant": qconv_residual_requant,
            "stem_requant_pool": stem_requant_pool,
            "dropout_matmul": dropout_matmul, "seeded_dropout": seeded_dropout,
            "seeded_dropout_pair": seeded_dropout_pair,
            "fused_bottleneck_stage": fused_bottleneck_stage}


# what the launch counters read, and K1's backward calls (plain PyTorch, no
# kernel of the port)
COUNT_NAMES = (*COUNTERS, "attention_pool_backward")


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    attention_pool_backward.calls = 0


def read_counts() -> dict:
    return {**{name: fn.launches for name, fn in COUNTERS.items()},
            "attention_pool_backward": attention_pool_backward.calls}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel entry of an nvcc ``-Xptxas -v`` log: registers,
    shared memory, spill stores and loads."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name[:90]}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return lines


def _time_ms(fn, iters: int, scrub: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after writing ``scrub`` (larger than L2) so every launch
    finds its inputs in device memory, as a serving caller would. A sleep
    kernel queued first holds the card while the host queues every launch,
    so the host's time to prepare a launch (the wrapper's checks and
    allocations, a tensor map's encoding) does not fall between the events
    as idle card time: what is timed is the work on the card, as in a
    caller that queues ahead (unless ``fn`` itself waits for the card)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(iters):
        scrub.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _bound(x, weight, v, mask, peak=None, products=1) -> tuple[float, str]:
    """Least time for the pool's work on these inputs: bytes moved (each input
    read once, each output written once) over the memory rate, against the
    operations over the peak rate for the input dtype (or ``peak``, with the
    projection done ``products`` times: 3xTF32). Only real (unmasked)
    patches need the projection, the gate and the pool."""
    n_b, bag, d = x.shape
    nbytes = (sum(t.numel() * t.element_size() for t in (x, weight, v, mask))
              + (n_b * d + n_b * bag) * 4)
    real = int(mask.sum())
    flops = products * 2 * real * d * d + 4 * real * d  # projection, gate dot, pool
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[x.dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_inputs(device: torch.device) -> tuple:
    """The pool's inputs at the main path's shape (float32), from SEED."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    x = torch.randn(B, BAG, D, generator=g).relu().to(device)
    weight = (torch.randn(D, D, generator=g) / math.sqrt(D)).to(device)
    v = (torch.randn(D, generator=g) * 0.05).to(device)
    mask = torch.ones(B, BAG, dtype=torch.bool, device=device)
    mask[1, 10:] = False  # a short bag
    mask[2] = False       # a padded sample
    return x, weight, v, mask


def check_attention_pool(device: torch.device) -> dict:
    """K1 against its plain version in float32 and bfloat16 (within
    ``KERNEL_TOL``), then timed after an L2 scrub in turns with the plain
    version and ``torch.matmul`` of its product. The float32 kernel runs
    3xTF32 on the tensor cores: its route's bound (3x the products at the
    TF32 rate) stands beside the float32 FMA bound."""
    x, weight, v, mask = k1_inputs(device)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dtype), weight.to(dtype)
        pooled, w = attention_pool(xd, wd, v, mask)
        torch.cuda.synchronize()
        want_pooled, want_w = attention_pool_plain(xd, wd, v, mask)
        err = max((pooled - want_pooled).abs().max().item(),
                  (w - want_w).abs().max().item())
        print(f"attention_pool {str(dtype)[6:]}: max_abs_err {err:.3e} "
              f"(tolerance {KERNEL_TOL})")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"attention_pool {dtype} disagrees with its "
                                 f"plain version: {err} > {KERNEL_TOL}")
        x2d = xd.view(-1, D)
        fns = {
            "kernel": lambda: attention_pool(xd, wd, v, mask),
            "plain": lambda: attention_pool_plain(xd, wd, v, mask),
            # one cuBLAS call for the product inside the kernel: a yardstick
            # only, the port never calls it
            "library": lambda: torch.matmul(x2d, wd.t()),
        }
        times = {k: [] for k in fns}
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
            times[name].append(_time_ms(fns[name], 25, scrub))
        bound_ms, bound_by = _bound(xd, wd, v, mask)
        result[str(dtype)[6:]] = {
            "max_abs_err": err,
            "ms": sum(times["kernel"]) / 2,
            "plain_ms": sum(times["plain"]) / 2,
            "library_ms": sum(times["library"]) / 2,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        if dtype == torch.float32:
            result["float32"]["bound_tf32x3_ms"] = _bound(
                xd, wd, v, mask, PEAK_TF32_FLOPS, 3)[0]
        print(f"attention_pool {str(dtype)[6:]}: {json.dumps(result[str(dtype)[6:]])}")
    return result


def check_attention_pool_grad(device: torch.device) -> dict:
    """K1's gradient: the ``AttentionPool`` Function (K1 forward, the
    analytic backward in plain PyTorch) against autograd of the plain
    version on the card, dx, dW and dv within ``K1_GRAD_TOL`` of each
    gradient's scale, at the main path's 16 x 16 x 2048 (padded), at
    128 x 2 x 2048 (padded) and at 128 x 1 x 2048, in float32 and bfloat16;
    then forward + backward and the backward alone timed after an L2
    scrub, in turns with the plain version's autograd. A bag of one patch
    has softmax weight 1 whatever its logit, so at 128 x 1 dW and dv are
    exactly 0 on both sides: there they are checked to be 0, and only dx
    is held to the tolerance."""
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    result = {}
    for where, n_b, bag in K1_GRAD_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(SEED + n_b)
        x = torch.randn(n_b, bag, D, generator=g).relu()
        weight = torch.randn(D, D, generator=g) / math.sqrt(D)
        v = torch.randn(D, generator=g) * 0.05
        mask = torch.ones(n_b, bag, dtype=torch.bool)
        if bag > 1:
            mask[1, max(1, bag - 6):] = False  # a short bag
            mask[2] = False                    # a padded sample
        g_out = torch.randn(n_b, D, generator=g)
        x, weight, v, mask, g_out = (t.to(device) for t in (x, weight, v, mask, g_out))
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd = x.to(dtype), weight.to(dtype)
            grads = {}
            for name, fn in (("function", pool), ("plain", attention_pool_plain)):
                leaves = [t.clone().requires_grad_() for t in (xd, wd, v)]
                out, _ = fn(*leaves, mask)
                out.backward(g_out)
                grads[name] = [t.grad for t in leaves]
            torch.cuda.synchronize()
            errs = {}
            for key, got, want in zip(("dx", "dW", "dv"), grads["function"], grads["plain"]):
                if bag == 1 and key != "dx":
                    if got.any() or want.any():
                        raise AssertionError(f"K1's {key} at {where} {dtype} is not 0 "
                                             "for bags of one patch")
                    continue
                errs[key] = ((got.float() - want.float()).abs().max()
                             / want.float().abs().max().clamp(min=1e-30)).item()
            tol = K1_GRAD_TOL[dtype]
            print(f"attention_pool gradient {where} {str(dtype)[6:]}: error / scale "
                  f"{json.dumps(errs)} (tolerance {tol})")
            if not max(errs.values()) <= tol:
                raise AssertionError(f"K1's gradient at {where} {dtype} disagrees with "
                                     f"autograd of the plain version: {errs} > {tol}")
            leaves = [t.clone().requires_grad_() for t in (xd, wd, v)]
            _, attn = attention_pool(xd, wd, v, mask)

            def step(fn):
                out, _ = fn(*leaves, mask)
                out.backward(g_out)

            fns = {"forward_backward": lambda: step(pool),
                   "plain": lambda: step(attention_pool_plain),
                   "backward": lambda: attention_pool_backward(
                       xd, wd, v, mask, attn, g_out, torch.zeros_like(attn))}
            times = {k: [] for k in fns}
            for name in ("plain", "forward_backward", "backward", "backward",
                         "forward_backward", "plain"):
                times[name].append(_time_ms(fns[name], 10, scrub))
            rec = {"max_err_over_scale": max(errs.values()), "tolerance": tol,
                   "held_to_tolerance": sorted(errs),
                   **{f"{k}_ms": sum(t) / 2 for k, t in times.items()}}
            print(f"attention_pool gradient {where} {str(dtype)[6:]}: {json.dumps(rec)}")
            result[f"{where} {str(dtype)[6:]}"] = rec
    return result


def _k3_inputs(batch, H, W, C, N, k, g, device):
    """int8 operands and a float32 epilogue whose outputs span ±127."""
    x = torch.randint(-127, 128, (batch, H, W, C), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, k, k, C), generator=g, dtype=torch.int8)
    scale = (40.0 / (math.sqrt(k * k * C) * 5376.0)) * (0.5 + torch.rand(N, generator=g))
    bias = torch.rand(N, generator=g) * 10 - 5
    return tuple(t.to(device) for t in (x, w, scale, bias))


def check_qmm_requant(device: torch.device) -> dict:
    """K3 against its plain version at the main path's shapes, relu on and
    off (identical int8 required), then timed with relu on. The yardstick is
    ``torch._int_mm`` on the same operands (the im2col matrix for a 3x3 or
    strided conv): the int8 product alone, without the epilogue."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    shapes = []
    for where, batch, H, W, C, N, k, stride, pad in K3_SHAPES:
        x, w, scale, bias = _k3_inputs(batch, H, W, C, N, k, g, device)
        conv = dict(stride=stride, padding=pad)
        mismatches, err = 0, 0
        for relu in (True, False):
            out = qconv_requant(x, w, scale, bias, relu=relu, **conv)
            torch.cuda.synchronize()
            want = qconv_requant_plain(x, w, scale, bias, relu=relu, **conv)
            mismatches += int((out != want).sum())
            err = max(err, int((out.int() - want.int()).abs().max()))
            del want
        M, K = out.shape[0] * out.shape[1] * out.shape[2], k * k * C
        cols = x.view(M, K) if (k, stride) == (1, 1) else im2col(x, k, k, stride, pad)
        w2 = w.view(N, K)
        fns = {
            "kernel": lambda: qconv_requant(x, w, scale, bias, **conv),
            "plain": lambda: qconv_requant_plain(x, w, scale, bias, **conv),
            # yardstick only: the port never calls it
            "library": lambda: torch._int_mm(cols, w2.t()),
        }
        times = {name: [] for name in fns}
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
            times[name].append(_time_ms(fns[name], 5 if name == "plain" else 25, scrub))
        nbytes = x.numel() + w.numel() + 8 * N + M * N
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * M * K * N / PEAK_INT8_OPS * 1e3
        rec = {
            "where": where, "M": M, "K": K, "N": N, "kernel": k,
            "stride": stride, "mismatches": mismatches, "max_abs_err": err,
            "ms": sum(times["kernel"]) / 2, "plain_ms": sum(times["plain"]) / 2,
            "library_ms": sum(times["library"]) / 2,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(f"qmm_requant {json.dumps(rec)}")
        if mismatches:
            raise AssertionError(f"qmm_requant at {where}: {mismatches} int8 "
                                 f"outputs differ from the plain version")
        shapes.append(rec)
        del x, w, cols, out
    return {
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        **{key: sum(r[key] for r in shapes)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": max(shapes, key=lambda r: r["bound_ms"])["bound_by"],
        "shapes": shapes,
    }


def _totals(recs: list) -> dict:
    """Times and bounds summed over the shapes, the largest error."""
    return {"max_abs_err": max(r["max_abs_err"] for r in recs),
            **{k: sum(r[k] for r in recs) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": max(recs, key=lambda r: r["bound_ms"])["bound_by"],
            "shapes": recs}


def check_residual_and_stem(device: torch.device) -> dict:
    """K3's residual form at the conv3 shapes of layers 1-4 and the stem
    pass at 224 px and at an odd size, each against its plain version
    (identical int8 required), then timed in turns with the plain version
    and the sequence it replaces: for the residual form the conv form
    (relu off) followed by the eager ``residual_relu_q``; for the stem the
    eager passes (its plain version). No single PyTorch call computes either
    function, so ``library_ms`` is null."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    s_t, s_r, s_out = (torch.tensor(v, device=device) for v in (0.05, 0.04, 0.06))
    residual = []
    for where, batch, H, W, C, N, projection in K3_RESIDUAL_SHAPES:
        x, w, scale, bias = _k3_inputs(batch, H, W, C, N, 1, g, device)
        if projection:
            xd, wd, sd, bd = _k3_inputs(batch, H, W, C, N, 1, g, device)
            r = qconv_requant(xd, wd, sd, bd, relu=False)
            del xd, wd
        else:
            r = torch.randint(-127, 128, (batch, H, W, N), generator=g,
                              dtype=torch.int8).to(device)
        args = (x, w, scale, bias, r, s_t, s_r, s_out)
        out = qconv_residual_requant(*args)
        torch.cuda.synchronize()
        want = qconv_residual_requant_plain(*args)
        mismatches = int((out != want).sum())
        err = int((out.int() - want.int()).abs().max())
        del want, out
        fns = {
            "kernel": lambda: qconv_residual_requant(*args),
            "plain": lambda: qconv_residual_requant_plain(*args),
            "two_calls": lambda: residual_relu_q(
                qconv_requant(x, w, scale, bias, relu=False), s_t, r, s_r, s_out),
        }
        times = {name: [] for name in fns}
        for name in ("plain", "kernel", "two_calls", "two_calls", "kernel", "plain"):
            times[name].append(_time_ms(fns[name], 3 if name == "plain" else 20, scrub))
        M = batch * H * W
        t_bytes = (x.numel() + w.numel() + 8 * N + 2 * M * N) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * M * C * N / PEAK_INT8_OPS * 1e3
        rec = {"where": where, "M": M, "K": C, "N": N, "mismatches": mismatches,
               "max_abs_err": err, "ms": sum(times["kernel"]) / 2,
               "plain_ms": sum(times["plain"]) / 2,
               "two_calls_ms": sum(times["two_calls"]) / 2,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"qconv_residual_requant {json.dumps(rec)}")
        if mismatches:
            raise AssertionError(f"qconv_residual_requant at {where}: {mismatches} "
                                 "int8 outputs differ from the plain version")
        residual.append(rec)
        del x, w, r, args, fns
    stem = []
    for where, batch, C, H, W in STEM_SHAPES:
        y = (torch.randn(batch, C, H, W, generator=g) * 2).to(device).contiguous(
            memory_format=torch.channels_last)
        bias = (torch.randn(C, generator=g) * 0.5).to(device)
        s = torch.tensor(0.02, device=device)
        out = stem_requant_pool(y, bias, s)
        torch.cuda.synchronize()
        want = stem_requant_pool_plain(y, bias, s)
        mismatches = int((out != want).sum())
        err = int((out.int() - want.int()).abs().max())
        del out, want
        fns = {"kernel": lambda: stem_requant_pool(y, bias, s),
               "plain": lambda: stem_requant_pool_plain(y, bias, s)}
        times = {name: [] for name in fns}
        for name in ("plain", "kernel", "kernel", "plain"):
            times[name].append(_time_ms(fns[name], 10, scrub))
        ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
        # y read once, the int8 map written once; 9 compares, an add and a
        # division per output at the float32 rate
        t_bytes = (4 * y.numel() + batch * ho * wo * C) / HBM_BYTES_PER_S * 1e3
        t_ops = 11 * batch * ho * wo * C / PEAK_FLOPS[torch.float32] * 1e3
        rec = {"where": where, "shape": [batch, C, H, W], "mismatches": mismatches,
               "max_abs_err": err, "ms": sum(times["kernel"]) / 2,
               "plain_ms": sum(times["plain"]) / 2, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"stem_requant_pool {json.dumps(rec)}")
        if mismatches:
            raise AssertionError(f"stem_requant_pool at {where}: {mismatches} int8 "
                                 "outputs differ from the plain version")
        stem.append(rec)
        del y, fns
    residual_total = _totals(residual)
    residual_total["two_calls_ms"] = sum(r["two_calls_ms"] for r in residual)
    # the main path's shape: 256 patches at 224 px
    return {"residual": residual_total,
            "stem": {**{k: v for k, v in stem[0].items() if k not in ("where", "shape")},
                     "shapes": stem}}


def _k4_stage(batch, cin, H, W, cm, n_blocks, g, device):
    """Seeded folded blocks (LeCun-normal weights, biases of 0.1) as modules
    and a post-ReLU channels_last float32 input."""
    blocks = []
    for j in range(n_blocks):
        blk = Bottleneck(cin if j == 0 else 4 * cm, cm, fold_bn=True)
        with torch.no_grad():
            for p in blk.parameters():
                p.copy_(torch.randn(p.shape, generator=g)
                        * (p[0].numel() ** -0.5 if p.dim() > 1 else 0.1))
        blocks.append(blk.to(device).eval())
    x = torch.randn(batch, cin, H, W, generator=g).relu()
    return blocks, x.to(device).contiguous(memory_format=torch.channels_last)


def check_fused_stage(device: torch.device) -> dict:
    """K4 against its plain version at both stage shapes of the main path,
    in bfloat16 and float32 (within ``K4_TOL`` of the output scale), then
    timed after an L2 scrub in turns with the plain version and the same
    stage through cuDNN (the folded blocks as an ``nn.Sequential`` in the
    dtype, ``channels_last``: a yardstick only, the port never calls it)."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    records = {}
    for where, batch, cin, H, W, cm, n_blocks in K4_STAGES:
        modules, x32 = _k4_stage(batch, cin, H, W, cm, n_blocks, g, device)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            packed = [pack_bottleneck(blk, dtype) for blk in modules]
            plans = [fused_block_plan(dtype, H, W, p.w1.shape[1], cm, p.w3.shape[0],
                                      p.wd is not None) for p in packed]
            with torch.inference_mode():
                out = fused_bottleneck_stage(x, packed)
                torch.cuda.synchronize()
                want = fused_bottleneck_stage_plain(x, packed)
                scale = max(1.0, want.abs().max().item())
                err = (out.float() - want.float()).abs().max().item()
                del out, want
                library = torch.nn.Sequential(*(copy.deepcopy(m) for m in modules))
                library = library.to(dtype).to(memory_format=torch.channels_last)
                fns = {
                    "kernel": lambda: fused_bottleneck_stage(x, packed),
                    "plain": lambda: fused_bottleneck_stage_plain(x, packed),
                    "library": lambda: library(x),
                }
                iters = {"kernel": 10, "plain": 3, "library": 10}
                if dtype == torch.float32:
                    iters["kernel"] = 3
                times = {name: [] for name in fns}
                for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
                    times[name].append(_time_ms(fns[name], iters[name], scrub))
            px = batch * H * W
            macs = px * sum(t.shape[0] * t.shape[1] for p in packed
                            for t in (p.w1, p.w2, p.w3, p.wd) if t is not None)
            nbytes = (x.numel() + px * packed[-1].w3.shape[0]) * x.element_size() + sum(
                t.numel() * t.element_size() for p in packed for t in p if t is not None)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * macs / PEAK_FLOPS[dtype] * 1e3
            kernel_ms = sum(times["kernel"]) / 2
            rec = {
                "where": where, "dtype": str(dtype)[6:], "shape": list(x.shape),
                "blocks": n_blocks, "plans": plans, "max_abs_err": err, "scale": scale,
                "tolerance": K4_TOL[dtype] * scale,
                "ms": kernel_ms, "plain_ms": sum(times["plain"]) / 2,
                "library_ms": sum(times["library"]) / 2,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "tflops": 2 * macs / kernel_ms / 1e9,
            }
            print(f"fused_bottleneck_stage {json.dumps(rec)}")
            if not err <= K4_TOL[dtype] * scale:
                raise AssertionError(f"fused_bottleneck_stage at {where} {dtype} disagrees "
                                     f"with its plain version: {err} > {K4_TOL[dtype]} x {scale}")
            records[(where, dtype)] = rec
            del x, packed, library, fns
        del modules, x32

    def total(dtype):
        recs = [r for (_, dt), r in records.items() if dt == dtype]
        return {"max_abs_err": max(r["max_abs_err"] for r in recs),
                **{k: sum(r[k] for r in recs)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                "bound_by": max(recs, key=lambda r: r["bound_ms"])["bound_by"],
                "stages": recs}

    return {"bfloat16": total(torch.bfloat16), "float32": total(torch.float32)}


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Seeded weights: LeCun-normal convs and linears (activations stay
    O(1) through 50 layers), BN statistics and affine near identity, and a
    non-zero attention vector so the softmax is not uniform."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    state = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            state[k] = v
        elif k.endswith("running_var") or (v.dim() == 1 and k.endswith("weight")):
            state[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k == "aggregator.vector":
            state[k] = torch.randn(v.shape, generator=g) * 0.05
        elif v.dim() == 1:
            state[k] = torch.randn(v.shape, generator=g) * 0.1
        else:
            fan_in = v[0].numel()
            state[k] = torch.randn(v.shape, generator=g) / math.sqrt(fan_in)
    return state


def make_cohort(root: str) -> tuple[str, int]:
    """8 slides x 64 patches at 224 px as packed shards + loc.txt, and a
    cohort CSV in which two cases have two slides each. Returns the CSV path
    and the number of cases."""
    rng = np.random.default_rng(SEED)
    cases = ["c0", "c1", "c2", "c3", "c4", "c4", "c5", "c5"]
    rows = ["case,survival_months,vital_status,wsi_file_name"]
    for i in range(N_WSI):
        wsi = f"S{i}"
        d = os.path.join(root, "patches", wsi)
        os.makedirs(d)
        with open(os.path.join(d, "loc.txt"), "w") as f:
            f.write(f"slide_id {wsi}\nid x y patch_level patch_size_read "
                    "patch_size_output\n")
            f.writelines(f"{j} {j * IMG} 0 0 {IMG} {IMG}\n" for j in range(N_PATCH))
        # written after loc.txt, so the shard is not stale
        np.save(os.path.join(d, "patches.npy"),
                rng.integers(0, 256, (N_PATCH, IMG, IMG, 3), dtype=np.uint8))
        rows.append(f"{cases[i]},{rng.uniform(1, 120):.4f},{int(rng.integers(0, 2))},"
                    f"{wsi}.svs")
    csv_path = os.path.join(root, "cohort.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path, len(set(cases))


def _config(root, csv_path, name, **overrides) -> tuple[dict, str]:
    cfg = {
        "model_name": "resnet50", "aggregator": "attention",
        "aggregator_hdim": 2048, "compute_dtype": "bfloat16",
        "img_size": IMG, "train_bag_size": BAG, "val_bag_size": BAG,
        "batch_size": B, "max_patch_per_wsi_train": N_PATCH,
        "max_patch_per_wsi_val": N_PATCH, "num_workers": 8, "num_classes": 1,
        "task": "survival_prediction", "flag": "chip_smoke",
        "data_path": os.path.join(root, "patches"), "train_csv_path": csv_path,
        "val_csv_path": csv_path, "test_csv_path": csv_path,
        "model_path": os.path.join(root, "model.pt"),
        "output_path": os.path.join(root, "out"),
    }
    cfg.update(overrides)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _check_outputs(out_dir: str, n_cases: int) -> None:
    for split in ("train", "val", "test"):
        score_csv = os.path.join(out_dir, f"model.pt_pathology_{split}_df.csv")
        with open(score_csv) as f:
            lines = f.read().splitlines()
        if lines[0] != ",id,score,survival_months,vital_status" or len(lines) != n_cases + 1:
            raise AssertionError(f"{score_csv}: unexpected frame {lines[:2]}")
        scores = np.array([float(line.split(",")[2]) for line in lines[1:]])
        feats = np.loadtxt(os.path.join(out_dir, f"pathology_features_{split}.csv"),
                           delimiter=",")
        with open(os.path.join(out_dir, f"pathology_cases_{split}.csv")) as f:
            n_rows = len(f.read().splitlines()) - 1
        if not (np.isfinite(scores).all() and np.isfinite(feats).all()
                and feats.shape == (n_cases, D) and n_rows == n_cases):
            raise AssertionError(f"{split}: bad outputs {scores} {feats.shape}")


def _run_clis(cfg_path: str) -> float:
    """savescore, then extract twice (the first run is cold: cuDNN set-up);
    returns the warm extract run's wall seconds."""
    histo_savescore.main(["--config", cfg_path])
    histo_extractfeatures.main(["--config", cfg_path])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    histo_extractfeatures.main(["--config", cfg_path])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def drive_main_path(root: str, device: torch.device, smi: str) -> tuple[dict, dict]:
    """The three serving paths through both CLIs: floating point, then
    ``quantize: "int8"``, then ``fold_bn: true``. Each path's launch counts
    are read just after its runs, with the counters set to 0 just before."""
    csv_path, n_cases = make_cohort(root)
    cfg, cfg_path = _config(root, csv_path, "main")
    model = build_mil_model(Config(cfg))
    torch.save(random_state_dict(model, SEED), cfg["model_path"])
    cfg8, cfg8_path = _config(root, csv_path, "int8", quantize="int8",
                              output_path=os.path.join(root, "out_int8"))
    cfgf, cfgf_path = _config(root, csv_path, "folded", fold_bn=True,
                              output_path=os.path.join(root, "out_folded"))
    batches = 3 * 3 * math.ceil(N_WSI * N_PATCH / BAG / B)  # 3 CLI runs x 3 splits
    patches = 3 * N_WSI * N_PATCH
    launches, e2e = {}, {}
    for path, (c, c_path) in (("bf16", (cfg, cfg_path)), ("int8", (cfg8, cfg8_path)),
                              ("bf16_folded", (cfgf, cfgf_path))):
        expected = {name: 0 for name in COUNT_NAMES}
        expected["attention_pool"] = batches
        if path == "int8":
            expected["qmm_requant"] = K3_LAUNCHES_PER_BATCH * batches
            expected["qconv_residual_requant"] = K3_RESIDUAL_PER_BATCH * batches
            expected["stem_requant_pool"] = STEM_PER_BATCH * batches
        if path == "bf16_folded":
            expected["fused_bottleneck_stage"] = K4_LAUNCHES_PER_BATCH * batches
        reset_counts()
        wall = _run_clis(c_path)
        counts = read_counts()
        print(f"main path {path}: launches {counts} (expected {expected})")
        if counts != expected:
            raise AssertionError(f"{path} path launched {counts}, expected {expected}")
        _check_outputs(c["output_path"], n_cases)
        print(f"{path} extract CLI (warm, wall clock incl. model load, "
              f"calibration and host loading): {patches / wall:.1f} patches/s, "
              f"{wall:.3f} s [{smi}]")
        launches[path] = counts
        e2e["extract_cli_patches_per_s" + ("" if path == "bf16" else "_" + path)] = \
            patches / wall
    e2e.update(check_main_path_batch(Config(cfg), device, smi))
    e2e.update(check_int8_batch(Config(cfg), Config(cfg8), device, smi))
    e2e.update(check_folded_batch(Config(cfg), Config(cfgf), device, smi))
    return launches, e2e


def check_main_path_batch(config: Config, device: torch.device, smi: str) -> dict:
    """One main-path batch: its pooled embedding through the kernel and the
    plain version from the same encoder features; the encoder's device time
    for the batch; the host's time to read a split's batches."""
    model = load_mil_model(config, device)
    adapter = MILAdapter(model=model, device=device)
    val = build_datasets(config, False)["val"]
    arrays = adapter.to_device(next(val.batches(B, num_threads=8)), adapter.array_keys)
    agg = model.aggregator
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    with torch.inference_mode():
        x = adapter.inputs(arrays)
        feats = model.patch_features(x)
        pooled, w = agg(feats, arrays["bag_mask"])
        want, want_w = attention_pool_plain(
            feats.to(agg.dtype), agg.linear.weight.to(agg.dtype), agg.vector,
            arrays["bag_mask"])
        encoder_ms = _time_ms(lambda: model.patch_features(x), 10, scrub)
        pool_ms = _time_ms(lambda: agg(feats, arrays["bag_mask"]), 25, scrub)
    err = (pooled - want).abs().max().item()
    rel = err / want.abs().max().item()
    print(f"main path batch: pooled max_abs_err {err:.3e} (relative {rel:.3e}), "
          f"weights max_abs_err {(w - want_w).abs().max().item():.3e}, "
          f"weights min/max {want_w.min().item():.4f}/{want_w.max().item():.4f}")
    if not (rel <= KERNEL_TOL and torch.allclose(w, want_w, rtol=0, atol=KERNEL_TOL)):
        raise AssertionError("main-path pooled embedding disagrees with plain")

    t0 = time.perf_counter()
    n_batches = sum(1 for _ in val.batches(B, num_threads=8))
    host_ms = (time.perf_counter() - t0) / n_batches * 1e3
    share = pool_ms / (encoder_ms + pool_ms)
    print(f"per batch of {B * BAG} patches: encoder {encoder_ms:.3f} ms, attention "
          f"pool (K1) {pool_ms:.4f} ms on the card, K1 {100 * share:.2f}% of the "
          f"two; host read {host_ms:.1f} ms [{smi}]")
    return {"encoder_ms_per_batch": encoder_ms, "pool_ms_per_batch": pool_ms,
            "pool_share_of_batch_device_time": share, "host_read_ms_per_batch": host_ms}


def device_breakdown(fn, wall_ms: float, label: str, ours: dict[str, str]) -> dict:
    """Device time by kernel of one call of ``fn`` (mean of 3, from
    ``torch.profiler``), its busy share of ``wall_ms`` (the call's CUDA-event
    time), and the time and launches per call of each of the port's kernels
    in ``ours`` (key → a substring of its kernel's name), as ``<key>_ms``
    and ``<key>_launches``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    # user annotations (``Optimizer.step#Adam.step``) span kernels that are
    # counted on their own
    kernels = sorted(((e.key, e.self_device_time_total / 3e3, e.count / 3)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    mine = {}
    for key, sub in ours.items():
        mine[f"{key}_ms"] = sum(ms for name, ms, _ in kernels if sub in name)
        mine[f"{key}_launches"] = sum(n for name, _, n in kernels if sub in name)
    print(f"{label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"({len(kernels)} kernel names); "
          + ", ".join(f"{k} {v:.3f}" for k, v in mine.items()) + "; top kernels:")
    for name, ms, n in kernels[:8]:
        print(f"  {ms:8.3f} ms  x{n:<6.2f} {name[:110]}")
    return {"device_busy_ms": busy, **mine,
            "top": [[name[:80], ms, n] for name, ms, n in kernels[:8]]}


def check_int8_batch(config: Config, config8: Config, device: torch.device,
                     smi: str) -> dict:
    """One main-path batch through the int8 path, calibrated as the CLIs
    calibrate: its bag embeddings against the float (bf16) path's; its
    int8 features on 32 patches through K3 (conv and residual forms) and the
    stem pass against the same forward through their plain versions, bit
    for bit; both encoders' device time."""
    datasets = build_datasets(config8, False)
    q_adapter = serving_adapter(config8, device, datasets)
    f_adapter = MILAdapter(model=load_mil_model(config, device), device=device)
    arrays = q_adapter.to_device(next(datasets["val"].batches(B, num_threads=8)),
                                 q_adapter.array_keys)
    qtree = q_adapter.qtree
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    with torch.inference_mode():
        real = arrays["sample_mask"]
        cos = torch.nn.functional.cosine_similarity(
            q_adapter.extract(arrays)[real].double(),
            f_adapter.extract(arrays)[real].double(), dim=1)
        x = q_adapter.inputs(arrays)
        x = x.reshape((-1,) + tuple(x.shape[2:]))
        sub = x[:32]
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        kernels = {"qconv_requant": qconv_requant,
                   "qconv_residual_requant": qconv_residual_requant,
                   "stem_requant_pool": stem_requant_pool}
        plains = {"qconv_requant": qconv_requant_plain,
                  "qconv_residual_requant": qconv_residual_requant_plain,
                  "stem_requant_pool": stem_requant_pool_plain}
        try:
            got_map, _ = quantize.quantized_stages(qtree, sub, stages=4)
            got = quantize.quantized_extract(qtree, sub)
            launched = read_counts()
            for name, fn in plains.items():
                setattr(quantize, name, fn)
            want_map, _ = quantize.quantized_stages(qtree, sub, stages=4)
            want = quantize.quantized_extract(qtree, sub)
        finally:
            for name, fn in kernels.items():
                setattr(quantize, name, fn)
            torch.backends.cudnn.deterministic = deterministic
        if read_counts() != launched:
            raise AssertionError("the plain forward launched a kernel")
        same = torch.equal(got_map, want_map) and torch.equal(got, want)
        int8_ms = _time_ms(lambda: quantize.quantized_extract(qtree, x), 10, scrub)
        xf = f_adapter.inputs(arrays)
        bf16_ms = _time_ms(lambda: f_adapter.model.patch_features(xf), 10, scrub)
    print(f"int8 batch: bag embedding cosine vs the bf16 path min "
          f"{cos.min().item():.6f} mean {cos.mean().item():.6f} over "
          f"{int(real.sum())} bags (contract > {INT8_COSINE}); int8 features of "
          f"{sub.shape[0]} patches through K3 and the stem pass equal the plain "
          f"forward: {same}")
    if not cos.min().item() > INT8_COSINE:
        raise AssertionError(f"int8 bag embeddings off the float path: {cos}")
    if not same:
        raise AssertionError("int8 features through K3 differ from the plain "
                             "version's forward")
    print(f"per batch of {x.shape[0]} patches: int8 encoder {int8_ms:.3f} ms, "
          f"bf16 encoder {bf16_ms:.3f} ms on the card [{smi}]")
    with torch.inference_mode():
        int8_profile = device_breakdown(
            lambda: quantize.quantized_extract(qtree, x), int8_ms, "int8 encoder",
            {"k3": "qconv_requant_kernel", "stem": "stem_requant_pool_kernel"})
        bf16_profile = device_breakdown(
            lambda: f_adapter.model.patch_features(xf), bf16_ms, "bf16 encoder",
            {"k3": "qconv_requant_kernel"})
    return {"int8_encoder_ms_per_batch": int8_ms,
            "bf16_encoder_ms_per_batch_int8_phase": bf16_ms,
            "int8_vs_bf16_bag_cosine_min": cos.min().item(),
            "int8_encoder_profile": int8_profile,
            "bf16_encoder_profile": bf16_profile}


@contextlib.contextmanager
def _stock_convs():
    """``fused_folded_extract`` with the stock folded modules around K4 (a
    convolution with its bias, then eager ReLU and residual add) in place of
    cuDNN's fused convolution + bias (+ residual) + ReLU calls."""
    saved = serving._conv_relu, serving._cudnn_bottleneck
    serving._conv_relu = lambda x, conv, wb: torch.relu(conv(x))
    serving._cudnn_bottleneck = lambda blk, x, weights: blk(x)
    try:
        yield
    finally:
        serving._conv_relu, serving._cudnn_bottleneck = saved


def check_folded_batch(config: Config, config_f: Config, device: torch.device,
                       smi: str) -> dict:
    """One main-path batch through the folded encoder (layer1 and layer2's
    tail through K4): its bag embeddings against the unfolded bf16 path's
    (per-sample cosine), device times in turns of the folded encoder, the
    same with the stock modules around K4 (what cuDNN's fused calls save),
    the unfolded one and, as a yardstick the port never serves with, the
    same folded weights through cuDNN alone (``ResNet.extract``), and the
    folded encoder's profile."""
    f_adapter = MILAdapter(model=load_mil_model(config_f, device), device=device)
    u_adapter = MILAdapter(model=load_mil_model(config, device), device=device)
    val = build_datasets(config, False)["val"]
    arrays = f_adapter.to_device(next(val.batches(B, num_threads=8)), f_adapter.array_keys)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    with torch.inference_mode():
        real = arrays["sample_mask"]
        launched = fused_bottleneck_stage.launches
        folded = f_adapter.extract(arrays)
        if fused_bottleneck_stage.launches - launched != K4_LAUNCHES_PER_BATCH:
            raise AssertionError("the folded encoder did not run K4 once per block")
        cos = torch.nn.functional.cosine_similarity(
            folded[real].double(), u_adapter.extract(arrays)[real].double(), dim=1)
        x = f_adapter.inputs(arrays)
        flat = x.reshape((-1,) + tuple(x.shape[2:]))
        def folded_stock_convs():
            with _stock_convs():
                return f_adapter.model.patch_features(x)

        fns = {"folded": lambda: f_adapter.model.patch_features(x),
               "folded_stock_convs": folded_stock_convs,
               "unfolded": lambda: u_adapter.model.patch_features(x),
               "folded_cudnn": lambda: f_adapter.model.resnet.extract(flat)}
        times = {name: [] for name in fns}
        order = ("unfolded", "folded", "folded_stock_convs", "folded_cudnn")
        for name in order + order[::-1]:
            times[name].append(_time_ms(fns[name], 10, scrub))
        folded_ms, stock_ms, unfolded_ms, cudnn_ms = (
            sum(times[n]) / 2 for n in ("folded", "folded_stock_convs", "unfolded",
                                        "folded_cudnn"))
    print(f"folded batch: bag embedding cosine vs the unfolded bf16 path min "
          f"{cos.min().item():.6f} mean {cos.mean().item():.6f} over {int(real.sum())} "
          f"bags (limit {FOLDED_COSINE})")
    if not cos.min().item() >= FOLDED_COSINE:
        raise AssertionError(f"folded bag embeddings off the unfolded path: {cos}")
    print(f"per batch of {x.shape[0] * x.shape[1]} patches: folded bf16 encoder "
          f"{folded_ms:.3f} ms ({stock_ms:.3f} ms with the stock modules around K4), "
          f"unfolded bf16 encoder {unfolded_ms:.3f} ms, folded through cuDNN alone "
          f"{cudnn_ms:.3f} ms on the card [{smi}]")
    with torch.inference_mode():
        profile = device_breakdown(fns["folded"], folded_ms, "folded bf16 encoder",
                                   {"k4": "fused_block_wgmma"})
    return {"folded_encoder_ms_per_batch": folded_ms,
            "folded_stock_convs_encoder_ms_per_batch": stock_ms,
            "unfolded_encoder_ms_per_batch_folded_phase": unfolded_ms,
            "folded_cudnn_encoder_ms_per_batch": cudnn_ms,
            "folded_vs_unfolded_bag_cosine_min": cos.min().item(),
            "folded_encoder_profile": profile}


def check_against_cpu(root: str, csv_path: str) -> None:
    """float32 scores on the card against the CPU path (plain versions),
    unfolded and with ``fold_bn: true`` (K4 in float32 on the card)."""
    for fold in (False, True):
        out = {}
        for dev in ("cuda", "cpu"):
            name = f"ref_{dev}" + ("_folded" if fold else "")
            cfg, cfg_path = _config(
                root, csv_path, name, compute_dtype="float32", batch_size=4,
                val_bag_size=4, train_bag_size=4, max_patch_per_wsi_train=4,
                max_patch_per_wsi_val=4, fold_bn=fold,
                output_path=os.path.join(root, name))
            launched = fused_bottleneck_stage.launches
            histo_savescore.main(["--config", cfg_path, "--device", dev])
            if dev == "cuda" and fold and fused_bottleneck_stage.launches == launched:
                raise AssertionError("the folded float32 path did not launch K4")
            with open(os.path.join(cfg["output_path"], "model.pt_pathology_val_df.csv")) as f:
                out[dev] = np.array([float(r.split(",")[2])
                                     for r in f.read().splitlines()[1:]])
        diff = np.abs(out["cuda"] - out["cpu"]).max()
        print(f"reference{' (fold_bn)' if fold else ''}: float32 scores cuda vs cpu "
              f"max_abs_diff {diff:.3e} (scale {np.abs(out['cpu']).max():.3e})")
        if not np.allclose(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"cuda scores {out['cuda']} != cpu {out['cpu']}")


def check_dropout_matmul(device: torch.device) -> dict:
    """K2a against its plain version at both RNA layer shapes (batch 256,
    drop probability 0.5; the mask and scaled values are the same, the
    float32 sums run in another order: within ``K2A_TOL``), K2b against its
    plain version on each layer's input (identical), then both timed after
    an L2 scrub, in turns with the plain version and a one-call PyTorch
    yardstick: ``torch.matmul`` of the pre-masked x (cuBLAS SGEMM, TF32 off)
    for K2a, ``torch.mul`` by the pre-scaled mask for K2b. Then K2b's
    paired form at dense_1's shape on two distinct inputs against two plain
    calls (identical), timed in turns with them and with two ``torch.mul``
    calls."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    p, seed = RNA_DROPOUT, 20240607
    k2a, k2b = [], []
    for where, M, K, N in K2_SHAPES:
        x = torch.randn(M, K, generator=g).to(device)
        w = (torch.randn(N, K, generator=g) / math.sqrt(K)).to(device)
        out = dropout_matmul(x, w, seed, p)
        dropped = seeded_dropout(x, seed, p)
        torch.cuda.synchronize()
        err = (out - dropout_matmul_plain(x, w, seed, p)).abs().max().item()
        dropped_plain = seeded_dropout_plain(x, seed, p)
        mismatches = int((dropped != dropped_plain).sum())
        b_err = (dropped - dropped_plain).abs().max().item()
        del dropped_plain
        xm = seeded_dropout_plain(x, seed, p)
        mask = keep_mask(M, K, seed, p, device).float() * float(keep_scale(p))
        fns = {
            "k2a": lambda: dropout_matmul(x, w, seed, p),
            "k2a_plain": lambda: dropout_matmul_plain(x, w, seed, p),
            # yardsticks only: the port never calls them
            "k2a_library": lambda: torch.matmul(xm, w.t()),
            "k2b": lambda: seeded_dropout(x, seed, p),
            "k2b_plain": lambda: seeded_dropout_plain(x, seed, p),
            "k2b_library": lambda: torch.mul(x, mask),
        }
        times = {name: [] for name in fns}
        for kind in ("k2a", "k2b"):
            for suffix in ("_plain", "", "_library", "_library", "", "_plain"):
                times[kind + suffix].append(_time_ms(fns[kind + suffix], 25, scrub))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        # K2a: x, w read and out written once; 2·M·K·N multiply-adds plus
        # the scaling of the kept x at the float32 FMA rate
        a_bytes = 4 * (M * K + N * K + M * N) / HBM_BYTES_PER_S * 1e3
        a_ops = (2 * M * K * N + M * K) / PEAK_FLOPS[torch.float32] * 1e3
        # the route taken: 3xTF32, three products at the TF32 tensor rate
        a_tf32 = 3 * 2 * M * K * N / PEAK_TF32_FLOPS * 1e3
        # K2b: x read, out written; one multiply per element
        b_bytes = 8 * M * K / HBM_BYTES_PER_S * 1e3
        b_ops = M * K / PEAK_FLOPS[torch.float32] * 1e3
        a = {"where": where, "M": M, "K": K, "N": N, "max_abs_err": err,
             "ms": ms["k2a"], "plain_ms": ms["k2a_plain"], "library_ms": ms["k2a_library"],
             "bound_ms": max(a_bytes, a_ops),
             "bound_by": "bytes" if a_bytes >= a_ops else "operations",
             "bound_tf32x3_ms": max(a_bytes, a_tf32),
             "tflops": 2 * M * K * N / ms["k2a"] / 1e9}
        b = {"where": where, "M": M, "K": K, "mismatches": mismatches, "max_abs_err": b_err,
             "ms": ms["k2b"], "plain_ms": ms["k2b_plain"], "library_ms": ms["k2b_library"],
             "bound_ms": max(b_bytes, b_ops),
             "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
        print(f"dropout_matmul {json.dumps(a)}")
        print(f"seeded_dropout {json.dumps(b)}")
        if not err <= K2A_TOL:
            raise AssertionError(f"dropout_matmul at {where} disagrees with its plain "
                                 f"version: {err} > {K2A_TOL}")
        if mismatches:
            raise AssertionError(f"seeded_dropout at {where}: {mismatches} values differ "
                                 "from the plain version")
        k2a.append(a)
        k2b.append(b)
        del x, w, out, dropped, xm, mask

    def total(recs, extra=()):
        return {"max_abs_err": max(r["max_abs_err"] for r in recs),
                **{k: sum(r[k] for r in recs)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms", *extra)},
                "bound_by": max(recs, key=lambda r: r["bound_ms"])["bound_by"],
                "shapes": recs}

    return {"dropout_matmul": total(k2a, ("bound_tf32x3_ms",)),
            "seeded_dropout": {"mismatches": sum(r["mismatches"] for r in k2b),
                               **total(k2b)},
            "seeded_dropout_pair": check_dropout_pair(device, g, scrub, seed, p)}


def check_dropout_pair(device: torch.device, g: torch.Generator, scrub: torch.Tensor,
                       seed: int, p: float) -> dict:
    """K2b's paired form at dense_1's shape (the backward's g·W and x) on two
    distinct inputs: identical to two plain calls, then timed after an L2
    scrub in turns with them and with two ``torch.mul`` calls by the
    pre-scaled mask."""
    (where, M, K, _), = [s for s in K2_SHAPES if s[0] == "dense_1"]
    a, b = (torch.randn(M, K, generator=g).to(device) for _ in range(2))
    out = seeded_dropout_pair(a, b, seed, p)
    torch.cuda.synchronize()
    want = seeded_dropout_pair_plain(a, b, seed, p)
    mismatches = sum(int((o != w).sum()) for o, w in zip(out, want))
    err = max((o - w).abs().max().item() for o, w in zip(out, want))
    mask = keep_mask(M, K, seed, p, device).float() * float(keep_scale(p))
    fns = {
        "pair": lambda: seeded_dropout_pair(a, b, seed, p),
        "plain": lambda: seeded_dropout_pair_plain(a, b, seed, p),
        # the yardstick only: the port never calls it
        "library": lambda: (torch.mul(a, mask), torch.mul(b, mask)),
    }
    times = {name: [] for name in fns}
    for name in ("plain", "pair", "library", "library", "pair", "plain"):
        times[name].append(_time_ms(fns[name], 25, scrub))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    # a and b read, both outputs written; one multiply per element of each
    t_bytes = 16 * M * K / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K / PEAK_FLOPS[torch.float32] * 1e3
    rec = {"where": where, "M": M, "K": K, "mismatches": mismatches, "max_abs_err": err,
           "ms": ms["pair"], "plain_ms": ms["plain"], "library_ms": ms["library"],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"seeded_dropout_pair {json.dumps(rec)}")
    if mismatches:
        raise AssertionError(f"seeded_dropout_pair at {where}: {mismatches} values "
                             "differ from two plain calls")
    return rec


def make_rna_cohort(root: str, sizes: dict, seed: int) -> dict:
    """Synthetic RNA CSVs (case, survival_months, vital_status, rna_0 …
    rna_12777; standard-normal expression, one case per row) from ``seed``.
    Returns each split's path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    header = "case,survival_months,vital_status," + ",".join(
        f"rna_{i}" for i in range(RNA_GENES))
    row = ",".join(["%.5g"] * RNA_GENES)
    paths = {}
    for split, n in sizes.items():
        x = rng.standard_normal((n, RNA_GENES), dtype=np.float32)
        months = rng.uniform(1, 120, n)
        status = rng.integers(0, 2, n)
        paths[split] = os.path.join(root, f"rna_{split}.csv")
        with open(paths[split], "w") as f:
            f.write(header + "\n")
            for i in range(n):
                f.write(f"{split}{i},{months[i]:.4f},{status[i]}," + row % tuple(x[i]) + "\n")
    return paths


def _rna_config(root: str, paths: dict, name: str, **overrides) -> tuple[dict, str]:
    cfg = {
        "batch_size": RNA_BATCH, "num_epochs": RNA_EPOCHS, "dropout": RNA_DROPOUT,
        "lr_rna": 1e-4, "lr_mlp": 1e-4, "weight_decay": 1e-5, "flag": "rna_smoke",
        "checkpoint_path": os.path.join(root, f"{name}_ckpt"),
        "output_path": os.path.join(root, f"{name}_serve"),
        **{f"{split}_csv_path": path for split, path in paths.items()},
    }
    cfg.update(overrides)
    cfg["model_path"] = os.path.join(cfg["checkpoint_path"], "models", "rna_smoke",
                                     "model_last.pt")
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _read_csv_column(path: str, column: str) -> list[str]:
    with open(path) as f:
        rows = list(csv.reader(f))
    return [r[rows[0].index(column)] for r in rows[1:]]


def _check_rna_outputs(cfg: dict, sizes: dict) -> None:
    """Every frame of the RNA path present, finite, of the expected shape."""
    frames = os.path.join(cfg["checkpoint_path"], "outputs", "rna_smoke")
    save = os.path.join(cfg["checkpoint_path"], "models", "rna_smoke")
    for name in ("model_last.pt", "model_dict_best.pt", "train_state.pt"):
        if not os.path.isfile(os.path.join(save, name)):
            raise AssertionError(f"{save}/{name} missing")
    for split, n in sizes.items():
        for tag in ("last", "best"):
            path = os.path.join(frames, f"{split}_output_{tag}.csv")
            with open(path) as f:
                header = f.readline().strip()
            scores = np.array(_read_csv_column(path, "score"), float)
            if header != "id,score,survival_months,vital_status" or scores.shape != (n,) \
                    or not np.isfinite(scores).all():
                raise AssertionError(f"{path}: bad frame {header} {scores.shape}")
        out = cfg["output_path"]
        scores = np.array(_read_csv_column(os.path.join(out, f"rna_{split}_df.csv"),
                                           "score"), float)
        feats = np.loadtxt(os.path.join(out, f"rna_features_{split}.csv"), delimiter=",")
        cases = _read_csv_column(os.path.join(out, f"rna_cases_{split}.csv"), "0")
        if not (scores.shape == (n,) and np.isfinite(scores).all() and len(cases) == n
                and feats.shape == (n, 2048) and np.isfinite(feats).all()):
            raise AssertionError(f"{split}: bad serving outputs {scores.shape} {feats.shape}")


def drive_rna_path(root: str, device: torch.device, smi: str,
                   k2a_ms_per_step: float) -> tuple[dict, dict]:
    """``rna_train`` (2 epochs, dropout 0.5), then ``rna_savescore`` and
    ``rna_extractfeatures`` on its ``model_last.pt``, at the reference width
    on ``cuda``. The counters are set to 0 just before each CLI and read just
    after it; then the train step's device time and profile, with K2a's
    share from its own timing (``k2a_ms_per_step``)."""
    paths = make_rna_cohort(os.path.join(root, "rna"), RNA_SPLITS, SEED)
    cfg, cfg_path = _rna_config(root, paths, "rna")
    steps = RNA_EPOCHS * math.ceil(RNA_SPLITS["train"] / RNA_BATCH)
    by_cli = {}
    for cli, main, expected in (
        ("rna_train", rna_train.main,
         {"dropout_matmul": K2A_PER_STEP * steps, "seeded_dropout": K2B_PER_STEP * steps,
          "seeded_dropout_pair": K2B_PAIR_PER_STEP * steps}),
        ("rna_savescore", rna_savescore.main, {}),
        ("rna_extractfeatures", rna_extractfeatures.main, {}),
    ):
        expected = {name: expected.get(name, 0) for name in COUNT_NAMES}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main(["--config", cfg_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(f"RNA path {cli}: launches {counts} (expected {expected}); {wall:.2f} s "
              f"wall clock with CSV parsing and checkpoints [{smi}]")
        if counts != expected:
            raise AssertionError(f"{cli} launched {counts}, expected {expected}")
        by_cli[cli] = {"launches": counts, "wall_s": wall}
    _check_rna_outputs(cfg, RNA_SPLITS)
    return by_cli, check_rna_train_step(Config(cfg), device, smi, k2a_ms_per_step)


def check_rna_train_step(config: Config, device: torch.device, smi: str,
                         k2a_ms_per_step: float) -> dict:
    """Device time of one RNA train step on a batch already on the card
    (CUDA events, mean of 10 after 3 warm-up steps), its profile, and the
    host's time to read and place a batch. ``torch.profiler`` drops some K2a
    records, so K2a's share of the step and the card's idle share use
    ``k2a_ms_per_step`` (K2a's own time at both layers) in place of the
    profiled K2a time."""
    ds = RNATableDataset(config["train_csv_path"])
    torch.manual_seed(SEED)
    model = build_rna_model(config, ds.feature_dim).to(device)
    adapter = TableAdapter(model=model, device=device)
    optimizer = tune_optimizer(build_rna_optimizer(model, config), config, len(ds),
                               num_epochs=RNA_EPOCHS, batch_size=RNA_BATCH)
    settings = TrainSettings(batch_size=RNA_BATCH)
    loss_fn, keys = make_loss_fn(settings)
    keys = adapter.array_keys + keys
    generator = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    for batch in ds.batches(RNA_BATCH, shuffle=True, seed=SEED):
        arrays = adapter.to_device(batch, keys)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / math.ceil(len(ds) / RNA_BATCH) * 1e3

    def step():
        return train_step(adapter, optimizer, loss_fn, arrays, settings, generator)

    for _ in range(3):
        step()
    events = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss = step()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = sum(s.elapsed_time(e) for s, e in events) / len(events)
    if not torch.isfinite(loss):
        raise AssertionError(f"RNA train step loss {loss.item()}")
    print(f"RNA train step (batch {RNA_BATCH}, 12,778 -> 4,096 -> 2,048 -> 1, float32, "
          f"dropout {RNA_DROPOUT}): {step_ms:.3f} ms on the card; host read and copy of "
          f"a batch {host_ms:.2f} ms [{smi}]")
    # "seeded_dropout_kernel" names both of K2b's forms (<V, false> and
    # <V, true>, the pair)
    profile = device_breakdown(step, step_ms, "RNA train step",
                               {"k2a": "::Dropout>", "k2b": "seeded_dropout_kernel"})
    busy = profile["device_busy_ms"] - profile["k2a_ms"] + k2a_ms_per_step
    print(f"RNA train step: K2a {k2a_ms_per_step:.3f} ms a step (its own timing), "
          f"{100 * k2a_ms_per_step / step_ms:.1f}% of the step; the card idle "
          f"{100 * (1 - busy / step_ms):.1f}% of it [{smi}]")
    return {"rna_train_step_ms": step_ms, "rna_host_batch_ms": host_ms,
            "rna_k2a_ms_per_step": k2a_ms_per_step,
            "rna_k2a_share_of_step": k2a_ms_per_step / step_ms,
            "rna_step_idle_share": 1 - busy / step_ms,
            "rna_train_step_profile": profile}


def check_rna_against_cpu(root: str) -> None:
    """A few dropout-free RNA train steps at the reference width on the card
    (K2) and on the CPU (plain versions) from one seeded init: the val
    scores must agree."""
    paths = make_rna_cohort(os.path.join(root, "rna_small"),
                            {"train": 32, "val": 16, "test": 16}, SEED + 1)
    scores = {}
    for dev in ("cuda", "cpu"):
        cfg, cfg_path = _rna_config(root, paths, f"rna_ref_{dev}", batch_size=16,
                                    num_epochs=1, dropout=0.0, lr_rna=1e-5, lr_mlp=1e-5)
        rna_train.main(["--config", cfg_path, "--device", dev])
        frame = os.path.join(cfg["checkpoint_path"], "outputs", "rna_smoke",
                             "val_output_last.csv")
        scores[dev] = np.array(_read_csv_column(frame, "score"), float)
    diff = np.abs(scores["cuda"] - scores["cpu"]).max()
    print(f"RNA reference: 2 dropout-free train steps, val scores cuda vs cpu "
          f"max_abs_diff {diff:.3e} (scale {np.abs(scores['cpu']).max():.3e})")
    if not np.allclose(scores["cuda"], scores["cpu"], rtol=1e-3, atol=1e-4):
        raise AssertionError(f"cuda scores {scores['cuda']} != cpu {scores['cpu']}")


def _check_train_outputs(cfg: dict) -> None:
    """Every checkpoint and frame of a ``histo_train`` run present, the
    frames finite with one row per slide."""
    flag = cfg["flag"]
    save = os.path.join(cfg["checkpoint_path"], "models", flag)
    for name in ("model_last.pt", "model_dict_best.pt", "train_state.pt"):
        if name != "model_dict_best.pt" or cfg["num_epochs"] > 1:
            if not os.path.isfile(os.path.join(save, name)):
                raise AssertionError(f"{save}/{name} missing")
    for split in ("train", "val", "test"):
        for tag in ("last", "best"):
            path = os.path.join(cfg["checkpoint_path"], "outputs", flag,
                                f"{split}_output_{tag}.csv")
            with open(path) as f:
                header = f.readline().strip()
            scores = np.array(_read_csv_column(path, "score"), float)
            if header != "id,score,survival_months,vital_status" \
                    or scores.shape != (N_WSI,) or not np.isfinite(scores).all():
                raise AssertionError(f"{path}: bad frame {header} {scores.shape}")


def drive_histo_train_path(root: str, device: torch.device, smi: str,
                           k1_ms: dict) -> tuple[dict, dict]:
    """``histo_train`` on the main path's cohort at ResNet-50 / attention
    2048 / bfloat16 / 224 px (batch 16, bags of 16, ``n_layers_to_train``
    2, augmentation on, 2 epochs, Adam at 5e-4), then ``histo_savescore``
    on its ``model_last.pt``, then ``histo_train`` with ``quantize_trunk:
    "int8"`` for 1 epoch (stem + 3 stages through K3). The counters are set
    to 0 just before each CLI and read just after it: K1 once a train step
    and an eval batch, its backward once a train step. Then one train
    step's device time, idle share and K1's share at ``n_layers_to_train``
    2 and 6 (``k1_ms``: K1's forward and backward times from phase 3)."""
    csv_path = os.path.join(root, "cohort.csv")
    n_bags = N_WSI * N_PATCH // BAG
    steps = math.ceil(n_bags / B)       # train steps an epoch
    split_batches = math.ceil(n_bags / B)
    # per epoch: the train steps, then the train and val evals; at the end
    # the last and the best model on the three splits
    def k1_forwards(epochs):
        return epochs * (steps + 2 * split_batches) + 6 * split_batches

    train = dict(checkpoint_path=os.path.join(root, "histo_train_ckpt"),
                 flag="histo_smoke", lr=HISTO_LR, weight_decay=1e-4,
                 n_layers_to_train=2, augment=True, log_interval=1)
    cfg, cfg_path = _config(root, csv_path, "histo_train", num_epochs=HISTO_EPOCHS,
                            **train)
    model_last = os.path.join(cfg["checkpoint_path"], "models", "histo_smoke",
                              "model_last.pt")
    serve, serve_path = _config(root, csv_path, "histo_train_serve", model_path=model_last,
                                output_path=os.path.join(root, "histo_train_serve"))
    cfg8, cfg8_path = _config(root, csv_path, "histo_train_int8", num_epochs=1,
                              quantize_trunk="int8",
                              **dict(train, checkpoint_path=os.path.join(
                                  root, "histo_train_int8_ckpt")))
    trunk_batches = k1_forwards(1)
    by_cli = {}
    for cli, main, c_path, expected in (
        ("histo_train", histo_train.main, cfg_path,
         {"attention_pool": k1_forwards(HISTO_EPOCHS),
          "attention_pool_backward": HISTO_EPOCHS * steps}),
        ("histo_savescore_trained", histo_savescore.main, serve_path,
         {"attention_pool": 3 * split_batches}),
        ("histo_train_int8_trunk", histo_train.main, cfg8_path,
         {"attention_pool": trunk_batches, "attention_pool_backward": steps,
          "qmm_requant": K3_TRUNK_PER_BATCH * trunk_batches,
          "qconv_residual_requant": K3_TRUNK_RESIDUAL_PER_BATCH * trunk_batches,
          "stem_requant_pool": trunk_batches}),
    ):
        expected = {name: expected.get(name, 0) for name in COUNT_NAMES}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main(["--config", c_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(f"histo train path {cli}: launches {counts} (expected {expected}); "
              f"{wall:.2f} s wall clock [{smi}]")
        if counts != expected:
            raise AssertionError(f"{cli} launched {counts}, expected {expected}")
        by_cli[cli] = {"launches": counts, "wall_s": wall}
    _check_train_outputs(cfg)
    _check_train_outputs(cfg8)
    for split in ("train", "val", "test"):
        path = os.path.join(serve["output_path"], f"model_last.pt_pathology_{split}_df.csv")
        scores = np.array(_read_csv_column(path, "score"), float)
        if not (scores.size and np.isfinite(scores).all()):
            raise AssertionError(f"{path}: bad scores {scores}")
    steps_e2e = {}
    for n in (2, 6):
        steps_e2e[f"n_layers_to_train_{n}"] = check_histo_train_step(
            Config(cfg), device, smi, n, k1_ms)
    return by_cli, {"histo_train_step": steps_e2e}


def check_histo_train_step(config: Config, device: torch.device, smi: str, n: int,
                           k1_ms: dict) -> dict:
    """Device time of one histo train step at ``n_layers_to_train`` ``n`` on
    a batch already on the card (CUDA events, mean of 5 after 3 warm-up
    steps), its profile and the card's idle share; K1's share of the step
    from K1's own forward and backward times (``k1_ms``)."""
    torch.manual_seed(SEED)
    model = build_mil_model(config).to(device, memory_format=torch.channels_last)
    adapter = MILAdapter(model=model, device=device, augment=True)
    optimizer = wrap_optimizer(build_grouped_optimizer(
        model, [("train", mil_freeze_ladder(n), HISTO_LR)], 1e-4))
    settings = TrainSettings(batch_size=B)
    loss_fn, keys = make_loss_fn(TrainSettings(task="survival_prediction"))
    keys = adapter.array_keys + keys
    train = build_datasets(config, False)["train"]
    batches = train.batches(B, shuffle=True, seed=SEED, num_threads=8)
    try:
        arrays = adapter.to_device(next(batches), keys)
    finally:
        batches.close()
    generator = torch.Generator(device=device).manual_seed(SEED)

    def step():
        return train_step(adapter, optimizer, loss_fn, arrays, settings, generator)

    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats(device)
    events = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss = step()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = sum(s.elapsed_time(e) for s, e in events) / len(events)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if not torch.isfinite(loss):
        raise AssertionError(f"histo train step loss {loss.item()}")
    launched = attention_pool.launches, attention_pool_backward.calls
    profile = device_breakdown(step, step_ms, f"histo train step, n_layers_to_train {n}",
                               {"k1_softmax_pool": "softmax_pool_kernel"})
    if (attention_pool.launches - launched[0], attention_pool_backward.calls - launched[1]) \
            != (4, 4):
        raise AssertionError("the profiled train steps did not run K1 and its "
                             "backward once a step")
    k1 = k1_ms["forward"] + k1_ms["backward"]
    idle = 1 - profile["device_busy_ms"] / step_ms
    print(f"histo train step (ResNet-50, attention 2048, bf16, {B} bags x {BAG} "
          f"patches at {IMG} px, augmentation on, n_layers_to_train {n}): {step_ms:.3f} "
          f"ms on the card, peak memory {peak_gb:.2f} GB, the card idle {100 * idle:.1f}% "
          f"of the step; K1 forward {k1_ms['forward']:.4f} + backward "
          f"{k1_ms['backward']:.4f} ms (their own timing), {100 * k1 / step_ms:.2f}% "
          f"of the step [{smi}]")
    return {"step_ms": step_ms, "idle_share": idle, "peak_memory_gb": peak_gb,
            "k1_forward_ms": k1_ms["forward"], "k1_backward_ms": k1_ms["backward"],
            "k1_share_of_step": k1 / step_ms, "profile": profile}


def check_histo_train_against_cpu(root: str) -> None:
    """Two train steps of a small float32 cohort (augmentation off, the
    whole network trained) on the card and on the CPU (plain versions)
    from one seeded init: the val scores must agree."""
    csv_path = os.path.join(root, "cohort.csv")
    scores = {}
    for dev in ("cuda", "cpu"):
        name = f"histo_train_ref_{dev}"
        cfg, cfg_path = _config(
            root, csv_path, name, compute_dtype="float32", batch_size=4,
            train_bag_size=2, val_bag_size=2, max_patch_per_wsi_train=2,
            max_patch_per_wsi_val=2, num_epochs=1, lr=1e-5, augment=False,
            n_layers_to_train=6, flag="ref", restore_path=os.path.join(root, "model.pt"),
            checkpoint_path=os.path.join(root, name))
        histo_train.main(["--config", cfg_path, "--device", dev])
        frame = os.path.join(cfg["checkpoint_path"], "outputs", "ref", "val_output_last.csv")
        scores[dev] = np.array(_read_csv_column(frame, "score"), float)
    diff = np.abs(scores["cuda"] - scores["cpu"]).max()
    print(f"histo train reference: 2 float32 train steps, val scores cuda vs cpu "
          f"max_abs_diff {diff:.3e} (scale {np.abs(scores['cpu']).max():.3e})")
    if not np.allclose(scores["cuda"], scores["cpu"], rtol=1e-3, atol=1e-4):
        raise AssertionError(f"cuda scores {scores['cuda']} != cpu {scores['cpu']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    configure_precision()
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    libs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          + ", ".join(str(p) for p in libs.values()))
    for name, log in build.build_logs.items():
        warnings = [line for line in log.splitlines()
                    if "warning" in line.lower() or "Performance Loss" in line]
        print(f"nvcc {name}: {len(warnings)} warnings")
        for line in warnings[:20] + ptxas_summary(log):
            print(f"  {line}")

    timings = check_attention_pool(device)
    k1_grad = check_attention_pool_grad(device)
    k1_ms = {"forward": timings["bfloat16"]["ms"],
             "backward": k1_grad[f"{K1_GRAD_SHAPES[0][0]} bfloat16"]["backward_ms"]}
    k3 = check_qmm_requant(device)
    k3_more = check_residual_and_stem(device)
    k2 = check_dropout_matmul(device)
    k4 = check_fused_stage(device)

    with tempfile.TemporaryDirectory() as root:
        launches, e2e = drive_main_path(root, device, smi)
        check_against_cpu(root, os.path.join(root, "cohort.csv"))
        rna_launches, rna_e2e = drive_rna_path(root, device, smi,
                                               k2["dropout_matmul"]["ms"])
        check_rna_against_cpu(root)
        train_launches, train_e2e = drive_histo_train_path(root, device, smi, k1_ms)
        check_histo_train_against_cpu(root)
    e2e.update(rna_e2e)
    e2e.update(train_e2e)
    for cli, rec in train_launches.items():
        launches[cli] = rec["launches"]
    k2_launches = {name: {cli: rec["launches"][name] for cli, rec in rna_launches.items()}
                   for name in ("dropout_matmul", "seeded_dropout", "seeded_dropout_pair")}
    k2_source = "multimodalbrainsurvival_torch/kernels/csrc/dropout_matmul.cu"
    # deleted from the JAX package; read it with git show 4fbc57a^:<file>
    k2_replaces = "multimodalbrainsurvival_tpu/ops/pallas/dropout_matmul.py:"
    k2b_pair = {"name": "seeded_dropout_pair", "route": "cuda", "source": k2_source,
                "replaces": k2_replaces + "135",
                "launches": sum(k2_launches["seeded_dropout_pair"].values()),
                "launches_by_path": k2_launches["seeded_dropout_pair"],
                **k2["seeded_dropout_pair"], "tolerance": 0}

    bf16 = timings["bfloat16"]
    by_path = {path: counts["attention_pool"] for path, counts in launches.items()}
    k3_by_path = {name: {path: counts[name] for path, counts in launches.items()
                         if counts[name]}
                  for name in ("qmm_requant", "qconv_residual_requant", "stem_requant_pool")}
    k4_launches = {path: counts["fused_bottleneck_stage"] for path, counts in launches.items()}
    print(json.dumps({"kernels": [{
        "name": "attention_pool",
        "route": "cuda",
        "source": "multimodalbrainsurvival_torch/kernels/csrc/attention_pool.cu",
        # retired from the JAX package; read it with git show 183b10c^:<file>
        "replaces": "multimodalbrainsurvival_tpu/ops/pallas/tanh_attention.py:111",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": bf16["max_abs_err"],
        "tolerance": KERNEL_TOL,
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "shape": [B, BAG, D],
        "dtype": "bfloat16",
        "float32": timings["float32"],
        # its gradient: the analytic backward in plain PyTorch (the JAX
        # package's _pool_bwd was stock jnp), no kernel of the port
        "backward": {
            "route": "plain PyTorch",
            "calls": sum(c["attention_pool_backward"] for c in launches.values()),
            "calls_by_path": {path: c["attention_pool_backward"]
                              for path, c in launches.items()
                              if c["attention_pool_backward"]},
            "checks": k1_grad,
        },
    }, {
        "name": "qmm_requant",
        "route": "cuda",
        "source": "multimodalbrainsurvival_torch/kernels/csrc/qmm_requant.cu",
        "replaces": "benchmarks/int8_pallas_probe.py:80",
        "launches": sum(k3_by_path["qmm_requant"].values()),
        "launches_by_path": k3_by_path["qmm_requant"],
        "max_abs_err": k3["max_abs_err"],
        "tolerance": 0,
        # times and bounds: sums over the shapes listed below (relu on)
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "shapes": k3["shapes"],
    }, {
        "name": "qconv_residual_requant",
        "route": "cuda",
        "source": "multimodalbrainsurvival_torch/kernels/csrc/qmm_requant.cu",
        # K3's kernel with the residual epilogue of the JAX package's
        # _residual_relu_q (multimodalbrainsurvival_tpu/models/quantize.py:214)
        "replaces": "benchmarks/int8_pallas_probe.py:80",
        "launches": sum(k3_by_path["qconv_residual_requant"].values()),
        "launches_by_path": k3_by_path["qconv_residual_requant"],
        "tolerance": 0,
        # times and bounds: sums over the shapes listed below
        **k3_more["residual"],
        "library_ms": None,
    }, {
        "name": "stem_requant_pool",
        "route": "cuda",
        "source": "multimodalbrainsurvival_torch/kernels/csrc/qmm_requant.cu",
        # the int8 stem's requant and max-pool after its conv (the JAX
        # package's _quantized_stages, multimodalbrainsurvival_tpu/models/
        # quantize.py:245-250), part of K3's int8 path
        "replaces": "benchmarks/int8_pallas_probe.py:80",
        "launches": sum(k3_by_path["stem_requant_pool"].values()),
        "launches_by_path": k3_by_path["stem_requant_pool"],
        "tolerance": 0,
        # times and bound: 256 patches at 224 px (the odd size below)
        **k3_more["stem"],
        "library_ms": None,
    }, {
        "name": "dropout_matmul",
        "route": "cuda",
        "source": k2_source,
        "replaces": k2_replaces + "160",
        "launches": sum(k2_launches["dropout_matmul"].values()),
        "launches_by_path": k2_launches["dropout_matmul"],
        # times and bounds: sums over the shapes listed (drop probability 0.5)
        **k2["dropout_matmul"],
        "tolerance": K2A_TOL,
    }, {
        "name": "seeded_dropout",
        "route": "cuda",
        "source": k2_source,
        "replaces": k2_replaces + "135",
        # K2b in both forms: the single form's launches and the pair's
        "launches": k2b_pair["launches"] + sum(k2_launches["seeded_dropout"].values()),
        "launches_by_path": {cli: n + k2b_pair["launches_by_path"][cli]
                             for cli, n in k2_launches["seeded_dropout"].items()},
        # the single form's times and bounds: sums over the shapes listed
        # (drop probability 0.5)
        **k2["seeded_dropout"],
        "tolerance": 0,
        # the paired form at dense_1's shape: two tensors, one launch
        "pair": k2b_pair,
    }] + [{
        "name": "fused_bottleneck_stage",
        "route": "cuda",
        "source": "multimodalbrainsurvival_torch/kernels/csrc/fused_stage.cu",
        # retired from the JAX package; read it with git show 183b10c^:<file>
        "replaces": "multimodalbrainsurvival_tpu/ops/pallas/fused_stage.py:150",
        "launches": sum(k4_launches.values()),
        "launches_by_path": k4_launches,
        # bfloat16, the main path's dtype; times and bounds: sums over
        # layer1 and layer2's tail at 256 patches (per stage below)
        **{key: k4["bfloat16"][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                 "bound_ms", "bound_by", "library_ms")},
        "tolerance": "%g of max(1, max|plain|)" % K4_TOL[torch.bfloat16],
        "stages": k4["bfloat16"]["stages"],
        "float32": k4["float32"],
    }], "rna_cli_wall_s": {cli: rec["wall_s"] for cli, rec in rna_launches.items()},
        "histo_train_cli_wall_s": {cli: rec["wall_s"] for cli, rec in train_launches.items()},
        **e2e}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
