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
   timed beside the plain version's autograd; K2a's and K2b's bf16 forms
   at the joint RNA encoder's shapes (batch 128: 12,778 -> 4,096 and
   4,096 -> 2,048; K2a within ``K2A_BF16_TOL`` of the output's scale, K2b
   single and paired bit for bit), timed beside ``torch.matmul`` /
   ``torch.mul`` of the same bf16 operands, and K2a in float32 at the
   early-fusion MLP's shapes (batch 256: 4,096 -> 2,048 -> 200 -> 1) and
   the joint head's (128 x 4,096 -> 1); at each of these shapes
   ``DropoutMatmul``'s gradients reach x and W and match autograd of the
   plain version;
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
   one seeded init; the val scores must agree;
10. histo tasks: the phase 8 configuration with ``task:
   "classification"`` (2 classes, ``target_label: "label"``) and with
   ``task: "survival_bin"`` (4 bins), each ``histo_train`` for 2 epochs
   then ``histo_savescore`` on its model (class probabilities in [0, 1]
   summing to 1; risks at most 0 and a finite C-index), and with
   ``aggregator: "transformer"`` (2 layers, 8 heads, 2048 wide) then
   ``histo_extractfeatures``; the counters set to 0 just before and read
   just after each CLI (K1 runs on both tasks' paths, never on the
   transformer's); then each one's train step at ``n_layers_to_train`` 2;
11. tasks reference: two float32 train steps of each new task on the card
   and on the CPU (as phase 9), and the transformer's float32 serving
   scores on the card and on the CPU from one seeded model;
12. preemption: ``histo_train`` of phase 8 in a process of its own, sent
   SIGTERM after its first ``bags/s`` line, must exit 143 and leave
   ``train_state.pt.preempt`` (the save's seconds and size are printed);
   rerun with ``resume: true`` it must take that state up, finish, delete
   it, and end with the weights of phase 8's uninterrupted run;
13. int8 RNA serving: phase 6's ``model_last.pt`` through ``rna_savescore``
   and ``rna_extractfeatures`` with ``quantize: "int8"`` at batch 256 (the
   test split 266 rows), no kernel of the port launched; the embeddings
   against phase 6's float ones (per-sample cosine > ``INT8_COSINE``);
   ``rna_extractfeatures`` again at batch 16, where every product is
   padded past 16 rows for ``torch._int_mm`` (the dataset pads each batch
   to the batch size, so at 256 none is), against the batch-256
   embeddings; a batch of 10 rows on the card against the CPU (equal int8
   weights, activations and int32 products), dense_0 and dense_1 timed
   beside K2a and SGEMM;
14. early fusion: a synthetic 4,096-feature cohort (train 1,024 / val 256
   / test 256, from a seed) through ``feature_train`` (2 epochs, batch 256,
   dropout 0.5, Adam at 1e-5, float32) and ``feature_savescore``, counted
   (K2a 3 and K2b 1 + 2 pairs a step) and checked; one train step timed;
15. joint fusion at the reference's joint scale (ResNet-50 and the RNA
   encoder in bf16, 224 px, batch 128 x bags of 1, LRs 5e-5 / 1e-6 / 1e-2,
   ``n_layers_to_train`` 2, augmentation on) on phase 4's slides with a
   12,778-gene vector per case: ``joint_train`` for 2 epochs,
   ``joint_savescore`` on its model in floating point, with ``fold_bn:
   true`` (K4) and ``quantize: "int8"`` (K3 and the int8 RNA MLP), and
   ``joint_train`` with ``quantize_trunk: "int8"`` for an epoch, each
   counted (K2a and K2b, bf16 forms apart, on training; K3 on int8 and the
   trunk; K4 on folded; K1 never) and its frames checked; the folded and
   int8 embeddings against the float ones by cosine; one train step timed;
16. fusion references: from one seeded init, two float32 dropout-free
   train steps of a small joint cohort (augmentation off) and of a small
   early-fusion cohort on the card and on the CPU; the val scores must
   agree;
17. late fusion, host input, the device cache and traces: (a) two of
   phase 4's slides written as PNG directories (a stdlib PNG writer), the
   C++ loader's decode of them and ``pack_patches`` on them against the
   shard rows bit for bit, and the host read of 16 bags x 16 from shards
   through the C++ batch assembler and through the thread pool it
   replaced, ``HOST_READ_RUNS`` turns a side; (b) phase 15's cohort through
   ``histo_savescore`` and ``histo_extractfeatures`` (K1 counted),
   ``rna_savescore`` and ``rna_extractfeatures`` (phase 6's model),
   ``concat_features`` (4,096 ``feature_`` columns), ``feature_train`` for
   an epoch (K2a and K2b counted), ``merge_scores`` and ``late_fusion``,
   every frame checked; (c) ``late_fusion`` on the card on seeded
   combined-score frames of 600 / 150 rows (the fit's time, CUDA graph
   launches and kernels), and the same fit on the CPU: lambda.min equal, beta
   and the CV curve within ``COXNET_TOL`` of their scale; (d) phase 8's
   ``histo_train`` with ``cache_patches_on_device`` (counted; its weights
   against phase 8's within phase 12's tolerance), an epoch's bags/s from
   the host loader and from the cache, the cache's bytes and upload
   seconds, a cached train step's idle share at ``n_layers_to_train`` 2,
   and ``joint_train`` for an epoch from the cache (K2a and K2b counted);
   (e) the cached ``histo_train`` run also has ``profile_steps:
   TRACE_STEPS``: its trace must hold the card's kernels;
18. whole-slide streaming: a 10,240 x 10,240 px slide (a noisy tissue
   square on white, about 1,700 tissue tiles; a PNG, and a 2-level
   deflate-tiled TIFF written by the port's ``data/tiff.py``) through
   ``slide_extractfeatures`` at ResNet-50 / attention 2048 / bf16 / 224 px,
   batches of 128: folded (K4), int8 (K3) and in floating point on the
   whole PNG; in floating point on the TIFF cut to ``STREAM_CUT_PATCHES``
   tiles (read by the port's ``TiffSlide``, first read back bit for bit:
   the first tiles of the PNG's float run, their features bit for bit);
   ``slide_joint_savescore`` (a 12,778-gene row) folded and int8 cut
   likewise; each counted (K1 once a slide) and its frames checked; the
   PNG's and the TIFF's float runs timed as they run (host tiling and its
   share, the TIFF's decode ms a tile, encoder, tail, tiles/s, the card's
   idle share); the card against the CPU over the first 32 tiles in float32; the
   streamed tiles and slide embedding against ``wsi2patches`` →
   ``pack_patches`` → ``histo_extractfeatures``; (a) the committed
   JPEG-tiled ``tests/data/torch_tiff/aperio_jpeg.svs`` (240-px 4:2:0 tiles
   under Photometric RGB, as Aperio writes them): every level and associated
   image at the digests of libjpeg's decode, streamed whole in bf16
   (counted) and in float32 against the two-step route; (b) K1 at the slide
   tail's shape (1, 2048, 2048) bf16 against its plain version, timed
   beside ``torch.matmul`` of its product; (c) the committed JPEG 2000
   fixtures ``aperio_j2k.svs`` (33003: 9/7, YCbCr samples) and
   ``aperio_j2k_rgb.svs`` (33005: 5/3, RGB), read by the port's own
   decoder (``data/csrc/j2k.cc``; the machine with the card has no
   Pillow) to the digests of the JAX reader's decode, the first streamed
   whole in bf16 (counted) and in
   float32 against the two-step route; a 33003 slide of the streaming
   slide's size assembled from the fixture's codestreams, cut to
   ``STREAM_CUT_PATCHES["tiff"]`` tiles and timed as it runs, its decode
   ms a tile and a block, tiles/s and idle share beside the deflate TIFF's
   and the PNG's;
19. exported serving: ``export_model`` on the card (MIL attention bf16,
   folded, int8; joint; RNA; no kernel launched while tracing), one
   ``serve`` thread on 127.0.0.1 serving all five (``--buckets 1,8
   --warmup 1``), ``SERVE_REQUESTS`` b64 requests a model (batches 1-8,
   bags of 16), counted (K1, K3 and K4 through the programs' custom ops),
   each response bit for bit a direct call of the loaded program and
   within ``SERVE_TOL`` of the eager adapters; health, listing, a 400;
   latency p50 / p95 and requests/s a model;
20. evaluation and orchestration: (a) ``validate_data`` on phase 4's slides
   in case-disjoint splits and on phase 6's RNA cohort (exit 0), and with
   a train case leaked into val (exit 1); (b) ``cv_run --task rna``, two
   folds of one epoch over the first ``CV_RNA_ROWS`` of phase 6's train
   rows at 12,778 genes (its test split fixed), and (c) ``cv_run --task histo`` over phase 4's
   slides at ResNet-50 / attention 2048 / bf16 / 224 px, each counted (K2a
   and K2b, K1 and its backward) with its fold frames, ``cv_summary.csv``,
   out-of-fold and ensemble frames checked; (d) ``sweep --task rna
   --halving 2`` over four ``lr_rna`` values, counted, its ranking and
   each combination's train state (the steps of its epochs) checked;
   (e) ``evaluate_scores`` over (b)'s out-of-fold and ensemble frames on
   the card and with ``--device cpu`` (the C-index and its bounds bit for
   bit, the rest within 1e-12), and the bootstrap at ``BOOT_CASES`` x
   ``BOOT_RESAMPLES`` timed on the card beside the host's numpy loop over
   ``HOST_BOOT_RESAMPLES`` of the same resamples (equal C-indices);
   (f) ``convert_checkpoint --arch resnet --in_channels 4`` on a seeded
   ResNet-50 and the ``rnfour`` encoder's forward on the card against the
   CPU in float32.

21. data, bag and tensor parallelism on the one card: (a) K2a and K2b
   with a rank's offsets in the global mask (``row0``, ``col0``) against
   their plain versions, a TP and a dp emulation against the unsharded
   calls, each form timed beside the offset-free call; (b) a world of
   ``P21_WORLD`` ranks sharing the card over gloo (this script in a
   process a rank, ``--phase21-worker``) runs ``rna_train`` under ``{"dp":
   2}``, ``histo_train`` under ``{"dp": 2}`` and ``{"dp": 1, "mp": 2,
   "shard_bag": true}``, ``joint_train`` and ``histo_extractfeatures``
   under ``{"dp": 2}``, the RNA encoder sharded over ``mp = 2`` at the
   reference width (float32 and bf16) and the dry run, each counted per
   rank and held against the same run at world 1, which this process runs
   meanwhile with BatchNorm in the synced arithmetic (and once with
   ``nn.BatchNorm2d``'s, the witness of how far rounding alone moves a
   bf16 ResNet-50's first step); (c) a world of one over NCCL through the
   collective helpers (``--phase21-nccl``); (d) ``rna_train`` preempted by a
   SIGTERM to rank 1 alone, resumed at world 2 (the uninterrupted run's
   weights) and at world 1; (e) the TP step's time at world 2 and 1 with
   its collectives' share (through the host: no NVLink figure); (f) a
   second world of ``P21_WORLD`` ranks, beside the first, runs under
   ``{"dp": 2}`` the rest of the mesh paths: the int8
   and folded ``histo_extractfeatures``, ``histo_train`` with the int8
   trunk and with the mesh-sharded device cache (float32, BatchNorm held),
   the int8 ``slide_extractfeatures`` on phase 18's slide and ``cv_run
   --task rna``, each counted per rank and held against its world-1 run,
   which this process also runs meanwhile.

The last lines are the ``kernels`` JSON line, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import functools
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from multimodalbrainsurvival_torch import artifact
from multimodalbrainsurvival_torch.cli import (
    concat_features,
    convert_checkpoint,
    cv_run,
    evaluate_scores,
    export_model,
    feature_savescore,
    feature_train,
    histo_extractfeatures,
    histo_savescore,
    histo_train,
    joint_savescore,
    joint_train,
    late_fusion,
    merge_scores,
    pack_patches,
    rna_extractfeatures,
    rna_savescore,
    rna_train,
    serve,
    slide_extractfeatures,
    slide_joint_savescore,
    sweep,
    validate_data,
    wsi2patches,
)
from multimodalbrainsurvival_torch.cli._common import (
    PREEMPTED_EXIT_CODE,
    build_datasets,
    build_mil_model,
    load_mil_model,
    serving_adapter,
    tune_optimizer,
)
from multimodalbrainsurvival_torch.cli.rna_train import build_rna_model, build_rna_optimizer
from multimodalbrainsurvival_torch.config import Config
from multimodalbrainsurvival_torch.data import (
    FeatureTableDataset,
    PatchBagDataset,
    RNATableDataset,
    native,
)
from multimodalbrainsurvival_torch.data import codecs, tiff, tiler
from multimodalbrainsurvival_torch.data.device_cache import DeviceCachedPatchBags
from multimodalbrainsurvival_torch.data.patches import read_csv_rows
from multimodalbrainsurvival_torch.device import configure_precision
from multimodalbrainsurvival_torch.frames import n_rows, read_frame, write_frame
from multimodalbrainsurvival_torch.kernels import build
from multimodalbrainsurvival_torch.kernels.attention_pool import (
    attention_pool,
    attention_pool_backward,
    attention_pool_plain,
    pool,
)
from multimodalbrainsurvival_torch.kernels.dropout_matmul import (
    DropoutMatmul,
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
from multimodalbrainsurvival_torch.models.convert import adapt_conv1_channels
from multimodalbrainsurvival_torch.models.resnet import (
    RESNET_CONSTRUCTORS,
    Bottleneck,
    SyncedBatchNorm2d,
    rnfour,
)
from multimodalbrainsurvival_torch.models.rna import RNA_GENES
from multimodalbrainsurvival_torch.ops.coxnet import CoxProblems, FistaSolver, fit_coxnet
from multimodalbrainsurvival_torch.ops.metrics import concordance_index
from multimodalbrainsurvival_torch.ops.survival import (
    bootstrap_concordance,
    bootstrap_pair_counts,
    resample_indices,
)
from multimodalbrainsurvival_torch.parallel import launch
from multimodalbrainsurvival_torch.train import checkpoint as train_checkpoint
from multimodalbrainsurvival_torch.train import TrainSettings
from multimodalbrainsurvival_torch.train.adapters import (
    JointAdapter,
    MILAdapter,
    TableAdapter,
)
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
# the histo tasks (phase 10): classification's classes, survival_bin's bins,
# and the transformer aggregator at the JAX package's width
TASK_CLASSES, TASK_BINS = 2, 4
TASKS = {
    "classification": {"task": "classification", "num_classes": TASK_CLASSES,
                       "target_label": "label"},
    "survival_bin": {"task": "survival_bin", "num_classes": TASK_BINS},
    "transformer": {"aggregator": "transformer", "transformer_layers": 2,
                    "task": "survival_prediction"},
}
# a preempted histo_train process (phase 12): its limits
PREEMPT_TIMEOUT_S = 300
COUNTERS = {"attention_pool": attention_pool, "qmm_requant": qmm_requant,
            "qconv_residual_requant": qconv_residual_requant,
            "stem_requant_pool": stem_requant_pool,
            "dropout_matmul": dropout_matmul, "seeded_dropout": seeded_dropout,
            "seeded_dropout_pair": seeded_dropout_pair,
            "fused_bottleneck_stage": fused_bottleneck_stage}


# the launches of K2a's and K2b's bf16 forms, counted beside the kernels'
# own counters (which count both dtypes)
BF16_COUNTERS = {"dropout_matmul_bf16": dropout_matmul,
                 "seeded_dropout_bf16": seeded_dropout,
                 "seeded_dropout_pair_bf16": seeded_dropout_pair}


# what the launch counters read, and K1's backward calls (plain PyTorch, no
# kernel of the port)
COUNT_NAMES = (*COUNTERS, *BF16_COUNTERS, "attention_pool_backward")


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    for fn in BF16_COUNTERS.values():
        fn.bf16_launches = 0
    attention_pool_backward.calls = 0


def read_counts() -> dict:
    return {**{name: fn.launches for name, fn in COUNTERS.items()},
            **{name: fn.bf16_launches for name, fn in BF16_COUNTERS.items()},
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
    # the classification label and the survival bin of a case follow its
    # number, so every split holds both classes
    rows = ["case,survival_months,vital_status,label,survival_bin,wsi_file_name"]
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
        case = int(cases[i][1:])
        rows.append(f"{cases[i]},{rng.uniform(1, 120):.4f},{int(rng.integers(0, 2))},"
                    f"{case % 2},{case % TASK_BINS},{wsi}.svs")
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


def make_rna_cohort(root: str, sizes: dict, seed: int, width: int = RNA_GENES,
                    prefix: str = "rna_") -> dict:
    """Synthetic RNA CSVs (case, survival_months, vital_status, rna_0 …
    rna_12777; standard-normal expression, one case per row) from ``seed``;
    with ``width`` and ``prefix`` the early-fusion feature tables
    (``feature_0`` … ``feature_4095``). Returns each split's path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    header = "case,survival_months,vital_status," + ",".join(
        f"{prefix}{i}" for i in range(width))
    row = ",".join(["%.5g"] * width)
    paths = {}
    for split, n in sizes.items():
        x = rng.standard_normal((n, width), dtype=np.float32)
        months = rng.uniform(1, 120, n)
        status = rng.integers(0, 2, n)
        paths[split] = os.path.join(root, f"{prefix}{split}.csv")
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


# the histo train path's batches: 8 slides x 64 patches in bags of 16, in
# batches of 16 (train steps an epoch, and eval batches a split)
HISTO_BATCHES = math.ceil(N_WSI * N_PATCH // BAG / B)


def _k1_forwards(epochs: int) -> int:
    """K1's forwards in a ``histo_train`` run with the attention pool: per
    epoch the train steps, then the train and val evals; at the end the
    last and the best model on the three splits."""
    return epochs * 3 * HISTO_BATCHES + 6 * HISTO_BATCHES


def _histo_train_keys(root: str, name: str) -> dict:
    """The phase 8 training keys (reference Adam LR, ladder at 2, flips and
    jitter on, a log line a step) with their own checkpoint directory."""
    return dict(checkpoint_path=os.path.join(root, name), flag="histo_smoke",
                lr=HISTO_LR, weight_decay=1e-4, n_layers_to_train=2, augment=True,
                log_interval=1)


def _run_counted(cli: str, main, cfg_path, expected, smi: str) -> dict:
    """Run a CLI with every launch counter set to 0 just before and read
    just after; the counts must be ``expected`` (0 where not named), or
    what ``expected()`` returns when called after the run (once its
    outputs say how many batches it ran). ``cfg_path``: the config's path,
    or the CLI's whole argv (a list)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main(cfg_path if isinstance(cfg_path, list) else ["--config", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if callable(expected):
        expected = expected()
    expected = {name: expected.get(name, 0) for name in COUNT_NAMES}
    print(f"{cli}: launches {counts} (expected {expected}); "
          f"{wall:.2f} s wall clock [{smi}]")
    if counts != expected:
        raise AssertionError(f"{cli} launched {counts}, expected {expected}")
    return {"launches": counts, "wall_s": wall}


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
    steps = split_batches = HISTO_BATCHES
    k1_forwards = _k1_forwards
    train = _histo_train_keys(root, "histo_train_ckpt")
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
        by_cli[cli] = _run_counted(cli, main, c_path, expected, smi)
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
                           k1_ms: dict, cached=None) -> dict:
    """Device time of one histo train step at ``n_layers_to_train`` ``n`` on
    a batch already on the card (CUDA events, mean of 5 after 3 warm-up
    steps), its profile and the card's idle share; K1's share of the step
    from K1's own forward and backward times (``k1_ms``). With ``cached``
    (a ``DeviceCachedPatchBags``) each step also takes its batch from the
    cache, as the train loop does: the index upload and the gathers."""
    torch.manual_seed(SEED)
    model = build_mil_model(config).to(device, memory_format=torch.channels_last)
    adapter = MILAdapter(model=model, device=device, augment=True)
    optimizer = wrap_optimizer(build_grouped_optimizer(
        model, [("train", mil_freeze_ladder(n), HISTO_LR)], 1e-4))
    settings = TrainSettings(batch_size=B)
    loss_fn, keys = make_loss_fn(TrainSettings(
        task=config.task, num_classes=config.num_classes,
        target_label=config.target_label))
    keys = adapter.array_keys + keys
    generator = torch.Generator(device=device).manual_seed(SEED)
    if cached is None:
        train = build_datasets(config, False)["train"]
        batches = train.batches(B, shuffle=True, seed=SEED, num_threads=8)
        try:
            arrays = adapter.to_device(next(batches), keys)
        finally:
            batches.close()

        def step():
            return train_step(adapter, optimizer, loss_fn, arrays, settings, generator)
    else:
        source = itertools.chain.from_iterable(
            cached.batches(B, shuffle=True, seed=r) for r in itertools.count())

        def step():
            return train_step(adapter, optimizer, loss_fn,
                              adapter.to_device(next(source), keys), settings, generator)

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
    what = f"task {config.task}, aggregator {config.aggregator}"
    origin = "" if cached is None else ", batches gathered from the device cache"
    profile = device_breakdown(step, step_ms,
                               f"histo train step ({what}), n_layers_to_train {n}{origin}",
                               {"k1_softmax_pool": "softmax_pool_kernel"})
    # the profile runs 4 steps: K1 and its backward once each with attention
    per_step = 1 if config.aggregator == "attention" else 0
    if (attention_pool.launches - launched[0], attention_pool_backward.calls - launched[1]) \
            != (4 * per_step, 4 * per_step):
        raise AssertionError(f"the profiled train steps ran K1 and its backward other "
                             f"than {per_step} time(s) a step")
    k1 = per_step * (k1_ms["forward"] + k1_ms["backward"])
    idle = 1 - profile["device_busy_ms"] / step_ms
    print(f"histo train step (ResNet-50, {what} 2048, bf16, {B} bags x {BAG} "
          f"patches at {IMG} px, augmentation on, n_layers_to_train {n}{origin}): "
          f"{step_ms:.3f} "
          f"ms on the card, peak memory {peak_gb:.2f} GB, the card idle {100 * idle:.1f}% "
          f"of the step; K1 forward {k1_ms['forward']:.4f} + backward "
          f"{k1_ms['backward']:.4f} ms (their own timing), {100 * k1 / step_ms:.2f}% "
          f"of the step [{smi}]")
    return {"step_ms": step_ms, "idle_share": idle, "peak_memory_gb": peak_gb,
            "k1_forward_ms": per_step * k1_ms["forward"],
            "k1_backward_ms": per_step * k1_ms["backward"],
            "k1_share_of_step": k1 / step_ms, "profile": profile}


def _task_init(root: str, name: str) -> str:
    """Seeded weights (``random_state_dict``) of the model of ``TASKS[name]``
    at the main path's widths, saved once; returns the ``.pt`` path."""
    path = os.path.join(root, f"model_{name}.pt")
    if not os.path.exists(path):
        cfg, _ = _config(root, os.path.join(root, "cohort.csv"), f"init_{name}",
                         **TASKS[name])
        torch.save(random_state_dict(build_mil_model(Config(cfg)), SEED), path)
    return path


def _score_columns(path: str) -> np.ndarray:
    """A frame's score columns (``score``, or ``score_0``, ``score_1``, …) as
    a (rows, columns) array."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    cols = [c for c in header if c.startswith("score")]
    return np.stack([np.array(_read_csv_column(path, c), float) for c in cols], axis=1)


def check_histo_train_against_cpu(root: str, name: str = "survival_prediction",
                                  **overrides) -> float:
    """Two train steps of a small float32 cohort (augmentation off, the
    whole network trained) on the card and on the CPU (plain versions)
    from one seeded init, with the task's ``overrides``: the val scores
    must agree. Returns their largest difference."""
    csv_path = os.path.join(root, "cohort.csv")
    init = _task_init(root, name) if overrides else os.path.join(root, "model.pt")
    scores = {}
    for dev in ("cuda", "cpu"):
        run = f"histo_train_ref_{name}_{dev}"
        cfg, cfg_path = _config(
            root, csv_path, run, compute_dtype="float32", batch_size=4,
            train_bag_size=2, val_bag_size=2, max_patch_per_wsi_train=2,
            max_patch_per_wsi_val=2, num_epochs=1, lr=1e-5, augment=False,
            n_layers_to_train=6, flag="ref", model_path=init,
            checkpoint_path=os.path.join(root, run), **overrides)
        histo_train.main(["--config", cfg_path, "--device", dev])
        scores[dev] = _score_columns(os.path.join(cfg["checkpoint_path"], "outputs", "ref",
                                                  "val_output_last.csv"))
    diff = np.abs(scores["cuda"] - scores["cpu"]).max()
    print(f"histo train reference ({name}): 2 float32 train steps, val scores cuda vs "
          f"cpu max_abs_diff {diff:.3e} (scale {np.abs(scores['cpu']).max():.3e})")
    if not np.allclose(scores["cuda"], scores["cpu"], rtol=1e-3, atol=1e-4):
        raise AssertionError(f"cuda scores {scores['cuda']} != cpu {scores['cpu']}")
    return float(diff)


def _check_task_frames(path: str, name: str, rows: int) -> dict:
    """A frame of one of phase 10's runs: its header, ``rows`` rows, finite
    scores; classification's probabilities in [0, 1] summing to 1,
    survival_bin's risks at most 0 and their C-index finite."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    header = [h for h in header if h]  # the serving frames' unnamed index
    want = (["id", "label"] + [f"score_{i}" for i in range(TASK_CLASSES)]
            if name == "classification" else ["id", "score", "survival_months",
                                              "vital_status"])
    scores = _score_columns(path)
    if header != want or scores.shape[0] != rows or not np.isfinite(scores).all():
        raise AssertionError(f"{path}: bad frame {header} {scores.shape}")
    if name == "classification":
        if scores.min() < 0 or scores.max() > 1 or \
                not np.allclose(scores.sum(axis=1), 1.0, rtol=0, atol=1e-6):
            raise AssertionError(f"{path}: not probabilities {scores}")
        return {}
    if name == "survival_bin":
        if scores.max() > 0:
            raise AssertionError(f"{path}: a survival_bin risk above 0: {scores}")
        months = np.array(_read_csv_column(path, "survival_months"), float)
        status = np.array(_read_csv_column(path, "vital_status"), float)
        ci = concordance_index(months, -scores[:, 0], status)
        if not np.isfinite(ci):
            raise AssertionError(f"{path}: C-index {ci}")
        return {"ci": ci}
    return {}


def drive_histo_tasks(root: str, device: torch.device, smi: str,
                      k1_ms: dict) -> tuple[dict, dict]:
    """Phase 10: ``histo_train`` at phase 8's configuration with each of
    ``TASKS`` for 2 epochs, then ``histo_savescore`` (the two tasks) or
    ``histo_extractfeatures`` (the transformer) on its ``model_last.pt``,
    the counters set to 0 just before and read just after each CLI; every
    frame checked; then each one's train step at ``n_layers_to_train`` 2."""
    csv_path = os.path.join(root, "cohort.csv")
    n_cases = len(set(_read_csv_column(csv_path, "case")))
    by_cli, steps_e2e = {}, {}
    for name, keys in TASKS.items():
        attention = keys.get("aggregator", "attention") == "attention"
        cfg, cfg_path = _config(root, csv_path, f"task_{name}", num_epochs=HISTO_EPOCHS,
                                model_path=_task_init(root, name),
                                **_histo_train_keys(root, f"task_{name}_ckpt"), **keys)
        model_last = os.path.join(cfg["checkpoint_path"], "models", "histo_smoke",
                                  "model_last.pt")
        out = os.path.join(root, f"task_{name}_serve")
        _, serve_path = _config(root, csv_path, f"task_{name}_serve", model_path=model_last,
                                output_path=out, **keys)
        serve = histo_savescore if attention else histo_extractfeatures
        train_expected = ({"attention_pool": _k1_forwards(HISTO_EPOCHS),
                           "attention_pool_backward": HISTO_EPOCHS * HISTO_BATCHES}
                          if attention else {})
        serve_expected = {"attention_pool": 3 * HISTO_BATCHES} if attention else {}
        by_cli[f"histo_train_{name}"] = _run_counted(
            f"histo_train ({name})", histo_train.main, cfg_path, train_expected, smi)
        serve_cli = f"{serve.__name__.rsplit('.', 1)[-1]}_{name}"
        by_cli[serve_cli] = _run_counted(serve_cli, serve.main, serve_path,
                                         serve_expected, smi)
        # the train run's frames: per WSI, per case for survival_bin
        rows = n_cases if name == "survival_bin" else N_WSI
        metrics = {}
        for split in ("train", "val", "test"):
            for tag in ("last", "best"):
                _check_task_frames(os.path.join(cfg["checkpoint_path"], "outputs",
                                                "histo_smoke",
                                                f"{split}_output_{tag}.csv"), name, rows)
            if attention:
                metrics[split] = _check_task_frames(
                    os.path.join(out, f"model_last.pt_pathology_{split}_df.csv"), name,
                    n_cases)
            else:
                feats = np.loadtxt(os.path.join(out, f"pathology_features_{split}.csv"),
                                   delimiter=",")
                if feats.shape != (n_cases, D) or not np.isfinite(feats).all():
                    raise AssertionError(f"transformer features {feats.shape}")
        print(f"histo task {name}: frames checked {metrics}")
        steps_e2e[name] = {"n_layers_to_train_2": check_histo_train_step(
            Config(cfg), device, smi, 2, k1_ms), "savescore": metrics}
    return by_cli, {"histo_task_train_step": steps_e2e}


def check_transformer_against_cpu(root: str) -> float:
    """The transformer's float32 serving scores (eval mode: no dropout) on
    the card and on the CPU from one seeded model; returns their largest
    difference."""
    csv_path = os.path.join(root, "cohort.csv")
    keys = TASKS["transformer"]
    model_path = _task_init(root, "transformer")
    out = {}
    for dev in ("cuda", "cpu"):
        name = f"transformer_ref_{dev}"
        cfg, cfg_path = _config(
            root, csv_path, name, compute_dtype="float32", batch_size=4, val_bag_size=4,
            train_bag_size=4, max_patch_per_wsi_train=4, max_patch_per_wsi_val=4,
            model_path=model_path, output_path=os.path.join(root, name), **keys)
        histo_savescore.main(["--config", cfg_path, "--device", dev])
        out[dev] = _score_columns(os.path.join(cfg["output_path"],
                                               "model_transformer.pt_pathology_val_df.csv"))
    diff = np.abs(out["cuda"] - out["cpu"]).max()
    print(f"transformer reference: float32 serving scores cuda vs cpu max_abs_diff "
          f"{diff:.3e} (scale {np.abs(out['cpu']).max():.3e})")
    if not np.allclose(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-4):
        raise AssertionError(f"cuda scores {out['cuda']} != cpu {out['cpu']}")
    return float(diff)


def _histo_train_process(cfg_path: str, sigterm_after_log: bool) -> tuple[int, str]:
    """``histo_train`` on the card in a process of its own; with
    ``sigterm_after_log`` it gets SIGTERM after its first ``bags/s`` line.
    Returns its exit status and output; the process is ended in any case."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "multimodalbrainsurvival_torch.cli.histo_train",
         "--config", cfg_path], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(PREEMPT_TIMEOUT_S, proc.kill)
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if sigterm_after_log and "bags/s" in line:
                proc.send_signal(signal.SIGTERM)
                sigterm_after_log = False
        code = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return code, "".join(lines)


def check_preemption(root: str, smi: str) -> dict:
    """Phase 12: phase 8's ``histo_train`` in a process, sent SIGTERM after
    its first log line, exits 143 and leaves ``train_state.pt.preempt``;
    rerun with ``resume: true`` it takes that state up, finishes, deletes
    it, and ends with phase 8's uninterrupted weights within the float32
    card-vs-CPU tolerance (cuDNN's backward may sum in another order)."""
    csv_path = os.path.join(root, "cohort.csv")
    keys = _histo_train_keys(root, "preempt_ckpt")
    cfg, cfg_path = _config(root, csv_path, "preempt", num_epochs=HISTO_EPOCHS, **keys)
    save = os.path.join(cfg["checkpoint_path"], "models", "histo_smoke")
    code, log = _histo_train_process(cfg_path, sigterm_after_log=True)
    saved = re.search(r"PREEMPTED: saved full train state \(epoch (\d+), batch (\d+), "
                      r"global step (\d+)\) to \S+ in (\S+) s \((\S+) MB\)", log)
    if code != PREEMPTED_EXIT_CODE or not saved or \
            not os.path.exists(os.path.join(save, "train_state.pt.preempt")):
        raise AssertionError(f"preempted histo_train: exit {code}, log:\n{log[-3000:]}")
    epoch, batch, step, save_s, state_mb = saved.groups()
    _, resume_path = _config(root, csv_path, "preempt_resume", num_epochs=HISTO_EPOCHS,
                             resume=True, **keys)
    code, log2 = _histo_train_process(resume_path, sigterm_after_log=False)
    if code != 0 or "train_state.pt.preempt: epoch" not in log2 or \
            os.path.exists(os.path.join(save, "train_state.pt.preempt")):
        raise AssertionError(f"resumed histo_train: exit {code}, log:\n{log2[-3000:]}")
    want = torch.load(os.path.join(root, "histo_train_ckpt", "models", "histo_smoke",
                                   "model_last.pt"), weights_only=True)
    got = torch.load(os.path.join(save, "model_last.pt"), weights_only=True)
    diff, differ = 0.0, 0
    for k, v in want.items():
        if not v.is_floating_point():
            if not torch.equal(got[k], v):
                raise AssertionError(f"{k}: {got[k]} != {v}")
            continue
        diff = max(diff, (got[k] - v).abs().max().item())
        differ += int((got[k] != v).sum())
        if not torch.allclose(got[k], v, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"resumed {k} differs from the uninterrupted run's by "
                                 f"{(got[k] - v).abs().max().item():.3e}")
    rec = {"epoch": int(epoch), "batch": int(batch), "step": int(step),
           "save_s": float(save_s), "state_mb": float(state_mb),
           "max_abs_diff": diff, "elements_differing": differ}
    print(f"preemption: SIGTERM -> exit {PREEMPTED_EXIT_CODE}, state saved at epoch "
          f"{epoch} batch {batch} (global step {step}) in {save_s} s, {state_mb} MB; "
          f"resumed to the end, weights vs the uninterrupted run max_abs_diff {diff:.3e} "
          f"({differ} elements differ) [{smi}]")
    return rec


# --- fusion and int8 RNA (phases 3, 13-16) ---------------------------------------

# the joint model (phase 15): ResNet-50 and the RNA encoder in bf16, 224 px,
# batches of 128 bags of 1 patch (config_joint_train.json), its Adam LRs
JOINT_BATCH, JOINT_EPOCHS = 128, 2
JOINT_LRS = {"lr_histo": 5e-5, "lr_rna": 1e-6, "lr_mlp": 1e-2}
# the joint path's batches an epoch and a split: 8 slides x 64 patches
JOINT_BATCHES = math.ceil(N_WSI * N_PATCH / JOINT_BATCH)
# K2a in bf16 at the joint RNA encoder's shapes (batch 128), in float32 at
# the early-fusion MLP's (batch 256) and the joint head's: (where, M, K, N, p)
K2_BF16_SHAPES = (("joint dense_0", JOINT_BATCH, RNA_GENES, 4096, 0.5),
                  ("joint dense_1", JOINT_BATCH, 4096, 2048, 0.5))
K2_FUSION_SHAPES = (("early dense_0", 256, 4096, 2048, 0.5),
                    ("early dense_1", 256, 2048, 200, 0.5),
                    ("early head", 256, 200, 1, 0.5),
                    ("joint head", JOINT_BATCH, 4096, 1, 0.8))
# K2a bf16 vs plain: the same bf16 operands, float32 sums in another order;
# within 1e-4 of the output's scale (a kernel that rounded its output to
# bf16 would miss it by 2**-9 / 1e-4 = 20x)
K2A_BF16_TOL = 1e-4
# DropoutMatmul's gradients vs autograd of the plain version, err / max(1,
# max|plain|): float32 1e-4; bf16 2**-7 (the backward's products in bf16)
K2_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-7}
# the early-fusion path (phase 14): 4,096 features (histo + RNA embeddings),
# batches of 256, 2 epochs, Adam at 1e-5, dropout 0.5
EARLY_WIDTH, EARLY_BATCH, EARLY_EPOCHS = 4096, 256, 2
EARLY_SPLITS = {"train": 1024, "val": 256, "test": 256}
# per train step of either fused model: K2a once per Dropout -> Linear pair
# (early: 3; joint: the encoder's 2 in bf16 and the head's in float32); K2b's
# single form on the first layer's data input, its pair on every other
# layer's g·W and x
EARLY_K2 = {"dropout_matmul": 3, "seeded_dropout": 1, "seeded_dropout_pair": 2}
JOINT_K2 = {"dropout_matmul": 3, "dropout_matmul_bf16": 2, "seeded_dropout": 1,
            "seeded_dropout_bf16": 1, "seeded_dropout_pair": 2,
            "seeded_dropout_pair_bf16": 1}


def _k2_bounds(M, K, N, dtype) -> dict:
    """K2a's least time: x and w read once, out (float32) written once,
    against 2·M·K·N operations at the dtype's peak (bf16 tensor, float32
    FMA)."""
    size = torch.finfo(dtype).bits // 8
    t_bytes = (size * (M * K + N * K) + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _grad_check(x, w, seed, p) -> float:
    """DropoutMatmul's dx and dW against autograd of the plain version on
    the card, err / max(1, max|plain|); raises if a gradient is zero."""
    g = torch.randn(x.shape[0], w.shape[0], device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(1))
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    DropoutMatmul.apply(tx, tw, seed, p).backward(g)
    px, pw = x.clone().requires_grad_(), w.clone().requires_grad_()
    dropout_matmul_plain(px, pw, seed, p).backward(g)
    torch.cuda.synchronize()
    err = 0.0
    for got, want in ((tx.grad, px.grad), (tw.grad, pw.grad)):
        if got.dtype != x.dtype or not got.abs().max().item() > 0:
            raise AssertionError("DropoutMatmul's gradient did not reach x or W")
        scale = max(1.0, want.float().abs().max().item())
        err = max(err, (got.float() - want.float()).abs().max().item() / scale)
    return err


def check_dropout_matmul_fusion(device: torch.device, smi: str) -> dict:
    """K2a and K2b in bf16 at the joint RNA encoder's shapes (K2a within
    ``K2A_BF16_TOL`` of its plain version's scale, K2b single and paired bit
    for bit), timed as phase 3 times (L2 scrubbed, behind the sleep kernel)
    in turns with the plain version and ``torch.matmul`` / ``torch.mul`` of
    the same bf16 operands; K2a in float32 at the early-fusion and joint head
    shapes within ``K2A_TOL``, timed beside SGEMM; at every shape
    ``DropoutMatmul``'s gradients against autograd of the plain version."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    seed = 20240608
    a_recs, b_recs, pair_recs, f32_recs = [], [], [], []
    for where, M, K, N, p in K2_BF16_SHAPES + K2_FUSION_SHAPES:
        bf16 = (where, M, K, N, p) in K2_BF16_SHAPES
        dtype = torch.bfloat16 if bf16 else torch.float32
        x = torch.randn(M, K, generator=g).to(device, dtype)
        w = (torch.randn(N, K, generator=g) / math.sqrt(K)).to(device, dtype)
        out = dropout_matmul(x, w, seed, p)
        torch.cuda.synchronize()
        want = dropout_matmul_plain(x, w, seed, p)
        err = (out - want).abs().max().item()
        scale = want.abs().max().item()
        tol = K2A_BF16_TOL * scale if bf16 else K2A_TOL
        grad_err = _grad_check(x, w, seed, p)
        xm = seeded_dropout_plain(x, seed, p)
        fns = {"k2a": lambda: dropout_matmul(x, w, seed, p),
               "k2a_plain": lambda: dropout_matmul_plain(x, w, seed, p),
               # yardstick only: the port never calls it
               "k2a_library": lambda: torch.matmul(xm, w.t())}
        kinds = ["k2a"]
        if bf16:
            b = torch.randn(M, K, generator=g).to(device, dtype)
            single = seeded_dropout(x, seed, p)
            pair = seeded_dropout_pair(x, b, seed, p)
            torch.cuda.synchronize()
            mismatches = int((single != xm).sum())
            pair_mismatches = int((pair[0] != xm).sum()) + int(
                (pair[1] != seeded_dropout_plain(b, seed, p)).sum())
            mask = (keep_mask(M, K, seed, p, device).float() * float(keep_scale(p))
                    ).to(dtype)
            fns.update({
                "k2b": lambda: seeded_dropout(x, seed, p),
                "k2b_plain": lambda: seeded_dropout_plain(x, seed, p),
                "k2b_library": lambda: torch.mul(x, mask),
                "pair": lambda: seeded_dropout_pair(x, b, seed, p),
                "pair_plain": lambda: seeded_dropout_pair_plain(x, b, seed, p),
                "pair_library": lambda: (torch.mul(x, mask), torch.mul(b, mask)),
            })
            kinds += ["k2b", "pair"]
        times = {name: [] for name in fns}
        for kind in kinds:
            for suffix in ("_plain", "", "_library", "_library", "", "_plain"):
                times[kind + suffix].append(_time_ms(fns[kind + suffix], 25, scrub))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        a = {"where": where, "M": M, "K": K, "N": N, "p": p,
             "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
             "scale": scale, "grad_err": grad_err, "ms": ms["k2a"],
             "plain_ms": ms["k2a_plain"], "library_ms": ms["k2a_library"],
             **_k2_bounds(M, K, N, dtype)}
        print(f"dropout_matmul {json.dumps(a)} [{smi}]")
        if not err <= tol:
            raise AssertionError(f"dropout_matmul at {where} ({dtype}) disagrees with "
                                 f"its plain version: {err} > {tol}")
        if not grad_err <= K2_GRAD_TOL[dtype]:
            raise AssertionError(f"DropoutMatmul's gradient at {where}: {grad_err}")
        (a_recs if bf16 else f32_recs).append(a)
        if bf16:
            for kind, n_in, bad, recs in (("k2b", 1, mismatches, b_recs),
                                          ("pair", 2, pair_mismatches, pair_recs)):
                t_bytes = 2 * 2 * n_in * M * K / HBM_BYTES_PER_S * 1e3
                t_ops = n_in * M * K / PEAK_FLOPS[torch.float32] * 1e3
                rec = {"where": where, "M": M, "K": K, "mismatches": bad,
                       "max_abs_err": 0.0 if not bad else float("nan"),
                       "ms": ms[kind], "plain_ms": ms[f"{kind}_plain"],
                       "library_ms": ms[f"{kind}_library"],
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
                print(f"seeded_dropout{'_pair' if kind == 'pair' else ''} bf16 "
                      f"{json.dumps(rec)} [{smi}]")
                if bad:
                    raise AssertionError(f"seeded_dropout ({kind}, bf16) at {where}: "
                                         f"{bad} values differ from the plain version")
                recs.append(rec)
        del x, w, out, want, xm

    def total(recs):
        return {"max_abs_err": max(r["max_abs_err"] for r in recs),
                **{k: sum(r[k] for r in recs)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                "bound_by": max(recs, key=lambda r: r["bound_ms"])["bound_by"],
                "shapes": recs}

    return {"dropout_matmul_bf16": total(a_recs), "seeded_dropout_bf16": total(b_recs),
            "seeded_dropout_pair_bf16": total(pair_recs),
            "dropout_matmul_fusion_f32": total(f32_recs)}


def drive_rna_int8(root: str, device: torch.device, smi: str, k2: dict) -> dict:
    """Phase 13: phase 6's ``model_last.pt`` through ``rna_savescore`` and
    ``rna_extractfeatures`` with ``quantize: "int8"`` at batch 256, the test
    split ragged (its last batch 10 rows, padded to 256 by the dataset); no
    kernel of the port runs (the int8 product is ``torch._int_mm``). The
    embeddings against phase 6's float ones (per-sample cosine >
    ``INT8_COSINE``); ``rna_extractfeatures`` at batch ``INT_MM_MIN_M``, so
    that every product of the CLI takes ``int8_matmul``'s row padding,
    against the batch-256 embeddings (per-row scales: a row's output does
    not depend on its batch); one batch of 10 rows on the card against the
    CPU (equal int8 weights, activations and int32 products), and dense_0
    and dense_1 (one ``_int8_linear`` with its input's requant) timed beside
    K2a's and SGEMM's phase 3 times."""
    from multimodalbrainsurvival_torch.cli.rna_train import load_rna_model
    from multimodalbrainsurvival_torch.models.quantize import (
        INT_MM_MIN_M,
        _int8_linear,
        _requant_rows,
        int8_matmul,
        quantize_rna_encoder,
        quantized_mlp,
    )

    paths = {split: os.path.join(root, "rna", f"rna_{split}.csv")
             for split in ("train", "val")}
    paths["test"] = make_rna_cohort(os.path.join(root, "rna_ragged"),
                                    {"test": RNA_BATCH + 10}, SEED + 2)["test"]
    cfg, cfg_path = _rna_config(root, paths, "rna_int8", quantize="int8",
                                checkpoint_path=os.path.join(root, "rna_ckpt"))
    by_cli = {}
    for cli, main in (("rna_savescore_int8", rna_savescore.main),
                      ("rna_extractfeatures_int8", rna_extractfeatures.main)):
        by_cli[cli] = _run_counted(cli, main, cfg_path, {}, smi)
    out, float_out = cfg["output_path"], os.path.join(root, "rna_serve")
    cosines = {}
    for split, n in (("train", RNA_SPLITS["train"]), ("val", RNA_SPLITS["val"]),
                     ("test", RNA_BATCH + 10)):
        scores = np.array(_read_csv_column(os.path.join(out, f"rna_{split}_df.csv"),
                                           "score"), float)
        feats = np.loadtxt(os.path.join(out, f"rna_features_{split}.csv"), delimiter=",")
        if not (scores.shape == (n,) and np.isfinite(scores).all()
                and feats.shape == (n, 2048) and np.isfinite(feats).all()):
            raise AssertionError(f"int8 {split}: bad outputs {scores.shape} {feats.shape}")
        if split != "test":
            want = np.loadtxt(os.path.join(float_out, f"rna_features_{split}.csv"),
                              delimiter=",")
            cos = np.sum(feats * want, 1) / np.maximum(
                np.linalg.norm(feats, axis=1) * np.linalg.norm(want, axis=1), 1e-30)
            cosines[split] = float(cos.min())
    print(f"int8 RNA serving: per-sample cosine to the float embeddings, min {cosines}")
    if min(cosines.values()) <= INT8_COSINE:
        raise AssertionError(f"int8 RNA embeddings: cosine {cosines} <= {INT8_COSINE}")
    small, small_path = _rna_config(root, paths, "rna_int8_small", quantize="int8",
                                    checkpoint_path=cfg["checkpoint_path"],
                                    batch_size=INT_MM_MIN_M)
    by_cli["rna_extractfeatures_int8_small"] = _run_counted(
        "rna_extractfeatures_int8_small", rna_extractfeatures.main, small_path, {}, smi)
    small_diff = 0.0
    for split in ("train", "val", "test"):
        name = f"rna_features_{split}.csv"
        got = np.loadtxt(os.path.join(small["output_path"], name), delimiter=",")
        want = np.loadtxt(os.path.join(out, name), delimiter=",")
        if got.shape != want.shape:
            raise AssertionError(f"int8 {split} at batch {INT_MM_MIN_M}: {got.shape}")
        small_diff = max(small_diff, float(np.abs(got - want).max()))
    print(f"int8 RNA extract at batch {INT_MM_MIN_M} (every product padded past "
          f"{INT_MM_MIN_M} rows) against batch {RNA_BATCH}: max_abs_diff {small_diff:.3e}")
    if small_diff > 1e-6:
        raise AssertionError(f"int8 RNA at batch {INT_MM_MIN_M}: {small_diff}")

    config = Config(cfg)
    model = load_rna_model(config, device, RNA_GENES)
    qtree = quantize_rna_encoder(model.rna_mlp)
    qtree_cpu = quantize_rna_encoder(load_rna_model(config, torch.device("cpu"),
                                                    RNA_GENES).rna_mlp)
    if qtree["layers"][0]["k"].shape != (4096, RNA_GENES + -RNA_GENES % 8):
        raise AssertionError("dense_0's int8 weight is not padded to a K multiple of 8")
    for got, want in zip(qtree["layers"], qtree_cpu["layers"]):
        if not all(torch.equal(got[k].cpu(), want[k]) for k in ("k", "ws", "b")):
            raise AssertionError("the int8 RNA weights differ between card and CPU")
    last = list(RNATableDataset(paths["test"]).batches(RNA_BATCH))[-1]
    x = torch.from_numpy(last["data"][last["mask"]])
    x_q, _ = _requant_rows(x)
    x_q_card, _ = _requant_rows(x.to(device))
    y32 = int8_matmul(x_q_card, qtree["layers"][0]["k"], 4096).cpu()
    if not (torch.equal(x_q_card.cpu(), x_q) and torch.equal(
            y32, int8_matmul(x_q, qtree_cpu["layers"][0]["k"], 4096))):
        raise AssertionError("the int8 RNA batch's int32 products differ card vs CPU")
    out_card = quantized_mlp(qtree, x.to(device)).cpu()
    out_cpu = quantized_mlp(qtree_cpu, x)
    diff = (out_card - out_cpu).abs().max().item()
    print(f"int8 RNA batch of {x.shape[0]} rows: int32 products equal card vs CPU; "
          f"outputs max_abs_diff {diff:.3e}")
    if not torch.allclose(out_card, out_cpu, rtol=1e-6, atol=1e-6):
        raise AssertionError(f"int8 RNA outputs card vs CPU differ by {diff}")

    # dense_0 and dense_1 at batch 256: the requant of the layer's input, the
    # int8 product and the epilogue
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    x = torch.randn(RNA_BATCH, RNA_GENES, device=device,
                    generator=torch.Generator(device=device).manual_seed(SEED))
    l0, l1 = qtree["layers"]

    def layer(lp, y, relu):
        return _int8_linear(lp, *_requant_rows(torch.relu(y) if relu else y))

    with torch.inference_mode():
        h = layer(l0, x, False)
        times = {"dense_0": _time_ms(lambda: layer(l0, x, False), 25, scrub),
                 "dense_1": _time_ms(lambda: layer(l1, h, True), 25, scrub)}
    k2a = {r["where"]: r for r in k2["dropout_matmul"]["shapes"]}
    layers = {}
    for name, (K, N) in (("dense_0", (RNA_GENES, 4096)), ("dense_1", (4096, 2048))):
        t_bytes = (4 * RNA_BATCH * K + N * K + 4 * RNA_BATCH * N) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * RNA_BATCH * K * N / PEAK_INT8_OPS * 1e3
        layers[name] = {"ms": times[name], "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "k2a_ms": k2a[name]["ms"], "sgemm_ms": k2a[name]["library_ms"]}
        print(f"int8 RNA {name} (batch {RNA_BATCH}; requant, torch._int_mm, epilogue): "
              f"{times[name]:.4f} ms; bound {layers[name]['bound_ms']:.4f} ms "
              f"({layers[name]['bound_by']}); K2a {k2a[name]['ms']:.4f} ms, SGEMM "
              f"{k2a[name]['library_ms']:.4f} ms (phase 3) [{smi}]")
    return {"launches": by_cli, "rna_int8_cosine_min": cosines,
            "rna_int8_card_vs_cpu_max_abs_diff": diff,
            "rna_int8_batch16_max_abs_diff": small_diff, "rna_int8_layers": layers}


def _check_frames(path: str, rows: int, index: bool = False) -> np.ndarray:
    """A score frame: its header, ``rows`` rows, finite scores."""
    with open(path) as f:
        header = f.readline().strip()
    want = ("," if index else "") + "id,score,survival_months,vital_status"
    scores = np.array(_read_csv_column(path, "score"), float)
    if header != want or scores.shape != (rows,) or not np.isfinite(scores).all():
        raise AssertionError(f"{path}: bad frame {header} {scores.shape}")
    return scores


def _train_step_profile(label: str, adapter, optimizer, arrays: dict, batch_size: int,
                        k2a_ms: float, smi: str) -> dict:
    """One train step's device time on a batch already on the card (CUDA
    events, mean of 5 after 3 warm-up steps), its profile, the card's idle
    share, and K2a's (its own phase-3 time, ``k2a_ms``; the profiler drops
    some of its records) and K2b's (profiled) share of the step."""
    settings = TrainSettings(batch_size=batch_size)
    loss_fn, _ = make_loss_fn(settings)
    generator = torch.Generator(device=adapter.generator_device).manual_seed(SEED)

    def step():
        return train_step(adapter, optimizer, loss_fn, arrays, settings, generator)

    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats(adapter.device)
    events = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss = step()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = sum(s.elapsed_time(e) for s, e in events) / len(events)
    peak_gb = torch.cuda.max_memory_allocated(adapter.device) / 1e9
    if not torch.isfinite(loss):
        raise AssertionError(f"{label} loss {loss.item()}")
    profile = device_breakdown(step, step_ms, label,
                               {"k2a": "::Dropout>", "k2b": "seeded_dropout_kernel"})
    busy = profile["device_busy_ms"] - profile["k2a_ms"] + k2a_ms
    share = (k2a_ms + profile["k2b_ms"]) / step_ms
    print(f"{label}: {step_ms:.3f} ms on the card, peak memory {peak_gb:.2f} GB, the "
          f"card idle {100 * (1 - busy / step_ms):.1f}% of it; K2a {k2a_ms:.4f} ms "
          f"(its own timing) + K2b {profile['k2b_ms']:.4f} ms, {100 * share:.2f}% of the "
          f"step [{smi}]")
    return {"step_ms": step_ms, "peak_memory_gb": peak_gb, "idle_share": 1 - busy / step_ms,
            "k2a_ms": k2a_ms, "k2b_ms": profile["k2b_ms"], "k2_share_of_step": share,
            "profile": profile}


def drive_early_fusion(root: str, device: torch.device, smi: str, k2: dict) -> tuple:
    """Phase 14: a synthetic 4,096-feature cohort (train 1,024 / val 256 /
    test 256, from a seed) through ``feature_train`` (2 epochs, batch 256,
    dropout 0.5, Adam at 1e-5, float32) and ``feature_savescore`` on its
    ``model_last.pt``, counted; the frames checked; one train step timed."""
    paths = make_rna_cohort(os.path.join(root, "early"), EARLY_SPLITS, SEED + 3,
                            width=EARLY_WIDTH, prefix="feature_")
    ckpt = os.path.join(root, "early_ckpt")
    cfg = {"batch_size": EARLY_BATCH, "num_epochs": EARLY_EPOCHS, "dropout": 0.5,
           "lr": 1e-5, "weight_decay": 1e-5, "flag": "early_smoke",
           "checkpoint_path": ckpt, "output_path": os.path.join(root, "early_serve"),
           "model_path": os.path.join(ckpt, "models", "early_smoke", "model_last.pt"),
           **{f"{split}_csv_path": path for split, path in paths.items()}}
    cfg_path = os.path.join(root, "early.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    steps = EARLY_EPOCHS * math.ceil(EARLY_SPLITS["train"] / EARLY_BATCH)
    by_cli = {
        "feature_train": _run_counted("feature_train", feature_train.main, cfg_path,
                                      {k: n * steps for k, n in EARLY_K2.items()}, smi),
        "feature_savescore": _run_counted("feature_savescore", feature_savescore.main,
                                          cfg_path, {}, smi),
    }
    for split, n in EARLY_SPLITS.items():
        for tag in ("last", "best"):
            _check_frames(os.path.join(ckpt, "outputs", "early_smoke",
                                       f"{split}_output_{tag}.csv"), n)
        _check_frames(os.path.join(cfg["output_path"],
                                   f"model_last.pt_feature_{split}_df.csv"), n, index=True)
    config = Config(cfg)
    torch.manual_seed(SEED)
    model = feature_train.build_feature_model(config, EARLY_WIDTH).to(device)
    adapter = TableAdapter(model=model, device=device)
    optimizer = wrap_optimizer(build_grouped_optimizer(model, [("all", "", 1e-5)], 1e-5))
    ds = FeatureTableDataset(paths["train"])
    arrays = adapter.to_device(next(ds.batches(EARLY_BATCH, shuffle=True, seed=SEED)),
                               adapter.array_keys + ("survival_months", "vital_status"))
    k2a_ms = sum(r["ms"] for r in k2["dropout_matmul_fusion_f32"]["shapes"]
                 if r["where"].startswith("early"))
    step = _train_step_profile(f"early-fusion train step (batch {EARLY_BATCH}, 4,096 -> "
                               "2,048 -> 200 -> 1, float32, dropout 0.5)", adapter,
                               optimizer, arrays, EARLY_BATCH, k2a_ms, smi)
    return by_cli, {"early_fusion_train_step": step}


def make_joint_csv(root: str) -> str:
    """The main path's cohort (phase 4) with a 12,778-gene RNA vector per
    case from a seed, as the joint CLIs read it."""
    rng = np.random.default_rng(SEED + 4)
    with open(os.path.join(root, "cohort.csv")) as f:
        lines = f.read().splitlines()
    vectors: dict[str, np.ndarray] = {}
    rows = [lines[0] + "," + ",".join(f"rna_{i}" for i in range(RNA_GENES))]
    for line in lines[1:]:
        case = line.split(",")[0]
        if case not in vectors:
            vectors[case] = rng.standard_normal(RNA_GENES, dtype=np.float32)
        rows.append(line + "," + ",".join("%.5g" % v for v in vectors[case]))
    path = os.path.join(root, "joint.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def _joint_config(root: str, csv_path: str, name: str, **overrides) -> tuple[dict, str]:
    """Phase 15's configuration: ResNet-50 and the RNA encoder in bf16, 224
    px, batches of 128 bags of 1, the reference's joint LRs, the ladder at 2,
    flips and jitter on."""
    keys = {"batch_size": JOINT_BATCH, "train_bag_size": 1, "val_bag_size": 1,
            "n_layers_to_train": 2, "augment": True, "flag": "joint_smoke",
            "weight_decay": 1e-5, "log_interval": 1, "model_path": "",
            "checkpoint_path": os.path.join(root, f"{name}_ckpt"), **JOINT_LRS}
    return _config(root, csv_path, name, **{**keys, **overrides})


def _joint_embeddings(configs: dict, device: torch.device) -> dict:
    """The (B, 4096) embeddings of one val batch through each serving
    adapter of ``configs`` (float, folded, int8)."""
    out = {}
    for mode, c in configs.items():
        config = Config(c)
        datasets = joint_train.build_joint_datasets(config, False)
        build = functools.partial(joint_train.build_joint_model, in_features=RNA_GENES)
        adapter = serving_adapter(config, device, datasets, build, JointAdapter)
        batch = next(datasets["val"].batches(JOINT_BATCH, num_threads=8))
        out[mode] = adapter.extract(adapter.to_device(batch, adapter.array_keys)
                                    ).double().cpu()
    return out


def drive_joint_path(root: str, device: torch.device, smi: str, k2: dict) -> tuple:
    """Phase 15: ``joint_train`` (2 epochs) on the main path's cohort with an
    RNA vector per case, ``joint_savescore`` on its model in floating point,
    with ``fold_bn: true`` and with ``quantize: "int8"``, then ``joint_train``
    with ``quantize_trunk: "int8"`` for an epoch; each counted (K2a and K2b
    on training, K3 on int8 and the trunk, K4 on folded, K1 never); the
    frames checked; the folded and int8 embeddings against the float ones;
    one train step timed."""
    csv_path = make_joint_csv(root)
    n_cases = len(set(_read_csv_column(csv_path, "case")))
    cfg, cfg_path = _joint_config(root, csv_path, "joint", num_epochs=JOINT_EPOCHS)
    model_last = os.path.join(cfg["checkpoint_path"], "models", "joint_smoke",
                              "model_last.pt")
    serve = {mode: _joint_config(root, csv_path, f"joint_serve_{mode}",
                                 model_path=model_last,
                                 output_path=os.path.join(root, f"joint_serve_{mode}"),
                                 **keys)
             for mode, keys in (("float", {}), ("folded", {"fold_bn": True}),
                                ("int8", {"quantize": "int8"}))}
    cfg8, cfg8_path = _joint_config(root, csv_path, "joint_int8", num_epochs=1,
                                    quantize_trunk="int8")
    steps = JOINT_BATCHES * JOINT_EPOCHS
    serve_batches = 3 * JOINT_BATCHES
    trunk_batches = JOINT_BATCHES * (1 + 2 + 6)  # train steps, 2 evals, 6 final evals
    by_cli = {"joint_train": _run_counted(
        "joint_train", joint_train.main, cfg_path,
        {k: n * steps for k, n in JOINT_K2.items()}, smi)}
    for mode, expected in (
        ("float", {}),
        ("folded", {"fused_bottleneck_stage": K4_LAUNCHES_PER_BATCH * serve_batches}),
        ("int8", {"qmm_requant": K3_LAUNCHES_PER_BATCH * serve_batches,
                  "qconv_residual_requant": K3_RESIDUAL_PER_BATCH * serve_batches,
                  "stem_requant_pool": STEM_PER_BATCH * serve_batches}),
    ):
        by_cli[f"joint_savescore_{mode}"] = _run_counted(
            f"joint_savescore_{mode}", joint_savescore.main, serve[mode][1], expected, smi)
    by_cli["joint_train_int8_trunk"] = _run_counted(
        "joint_train_int8_trunk", joint_train.main, cfg8_path,
        {**{k: n * JOINT_BATCHES for k, n in JOINT_K2.items()},
         "qmm_requant": K3_TRUNK_PER_BATCH * trunk_batches,
         "qconv_residual_requant": K3_TRUNK_RESIDUAL_PER_BATCH * trunk_batches,
         "stem_requant_pool": trunk_batches}, smi)
    for c in (cfg, cfg8):
        for split in ("train", "val", "test"):
            for tag in ("last", "best"):
                _check_frames(os.path.join(c["checkpoint_path"], "outputs", "joint_smoke",
                                           f"{split}_output_{tag}.csv"), N_WSI)
    for mode, (c, _) in serve.items():
        for split in ("train", "val", "test"):
            _check_frames(os.path.join(c["output_path"],
                                       f"model_last.pt_joint_{split}_df.csv"), n_cases,
                          index=True)
    emb = _joint_embeddings({mode: c for mode, (c, _) in serve.items()}, device)
    cosine = {}
    for mode, floor in (("folded", FOLDED_COSINE), ("int8", INT8_COSINE)):
        cos = torch.nn.functional.cosine_similarity(emb[mode], emb["float"], dim=1)
        cosine[mode] = cos.min().item()
        if not cosine[mode] >= floor:
            raise AssertionError(f"joint {mode} embeddings: cosine {cosine[mode]} < {floor}")
    print(f"joint serving: per-sample cosine of the 4,096-d embeddings to the float "
          f"path, min {cosine}")

    config = Config(cfg)
    torch.manual_seed(SEED)
    model = joint_train.build_joint_model(config, in_features=RNA_GENES).to(
        device, memory_format=torch.channels_last)
    adapter = JointAdapter(model=model, device=device, augment=True)
    optimizer = wrap_optimizer(joint_train.build_joint_optimizer(model, config))
    train = joint_train.build_joint_datasets(config, False)["train"]
    batches = train.batches(JOINT_BATCH, shuffle=True, seed=SEED, num_threads=8)
    try:
        arrays = adapter.to_device(next(batches), adapter.array_keys
                                   + ("survival_months", "vital_status"))
    finally:
        batches.close()
    k2a_ms = k2["dropout_matmul_bf16"]["ms"] + sum(
        r["ms"] for r in k2["dropout_matmul_fusion_f32"]["shapes"]
        if r["where"] == "joint head")
    step = _train_step_profile(
        f"joint train step (ResNet-50 + RNA 12,778 -> 4,096 -> 2,048, bf16, "
        f"{JOINT_BATCH} bags of 1 at {IMG} px, augmentation on, n_layers_to_train 2)",
        adapter, optimizer, arrays, JOINT_BATCH, k2a_ms, smi)
    return by_cli, {"joint_train_step": step, "joint_serving_cosine_min": cosine}


def check_fusion_against_cpu(root: str) -> dict:
    """Phase 16: from one seeded init, two float32 dropout-free train steps
    on the card (K2a, K2b, cuDNN) and on the CPU (plain versions) of a small
    joint cohort (augmentation off, the whole network) and of a small
    early-fusion cohort: the val scores must agree."""
    csv_path = os.path.join(root, "joint.csv")
    init = os.path.join(root, "model_joint.pt")
    cfg, _ = _joint_config(root, csv_path, "joint_init")
    torch.save(random_state_dict(joint_train.build_joint_model(
        Config(cfg), in_features=RNA_GENES), SEED), init)
    paths = make_rna_cohort(os.path.join(root, "early_small"),
                            {"train": 32, "val": 16, "test": 16}, SEED + 6,
                            width=EARLY_WIDTH, prefix="feature_")
    diffs = {}
    for name in ("joint", "early"):
        scores = {}
        for dev in ("cuda", "cpu"):
            run = f"{name}_ref_{dev}"
            if name == "joint":
                c, c_path = _joint_config(
                    root, csv_path, run, compute_dtype="float32", batch_size=4,
                    train_bag_size=2, val_bag_size=2, max_patch_per_wsi_train=2,
                    max_patch_per_wsi_val=2, num_epochs=1, augment=False, dropout=0.0,
                    n_layers_to_train=6, model_path=init, flag="ref",
                    lr_histo=1e-5, lr_rna=1e-5, lr_mlp=1e-5)
                joint_train.main(["--config", c_path, "--device", dev])
            else:
                c = {"batch_size": 16, "num_epochs": 1, "dropout": 0.0, "lr": 1e-5,
                     "weight_decay": 1e-5, "flag": "ref",
                     "checkpoint_path": os.path.join(root, run),
                     **{f"{split}_csv_path": p for split, p in paths.items()}}
                c_path = os.path.join(root, f"{run}.json")
                with open(c_path, "w") as f:
                    json.dump(c, f)
                feature_train.main(["--config", c_path, "--device", dev])
            scores[dev] = np.array(_read_csv_column(os.path.join(
                c["checkpoint_path"], "outputs", "ref", "val_output_last.csv"), "score"),
                float)
        diffs[name] = float(np.abs(scores["cuda"] - scores["cpu"]).max())
        print(f"{name} fusion reference: 2 float32 train steps, val scores cuda vs cpu "
              f"max_abs_diff {diffs[name]:.3e} (scale {np.abs(scores['cpu']).max():.3e})")
        if not np.allclose(scores["cuda"], scores["cpu"], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"{name}: cuda scores {scores['cuda']} != cpu "
                                 f"{scores['cpu']}")
    return diffs


# --- phase 17: late fusion, the C++ batch assembler, the device cache, traces ---

# the slides of phase 4 written as PNG directories (17a)
PNG_SLIDES = ("S0", "S1")
# host reads timed a side, alternating (17a)
HOST_READ_RUNS = 12
# the late-fusion cohort (17c): seeded combined-score frames, ties in time
# (3-month grid), about 40% censored; its seed gives a CV curve whose two
# lowest points lie 2.5e-6 of their value apart (printed), some twenty
# float32 roundings, so card and CPU pick one lambda.min
LATE_SPLITS, LATE_SEED = {"train": 600, "val": 150}, 3
LATE_EFFECTS = {"path_score": 0.8, "rna_score": 0.4}
# card vs CPU fit: β and the CV curve within this share of their scale;
# float32 sums in another order (the card's scans)
COXNET_TOL = 1e-4
# train steps in the trace of the cached histo_train run (17d, 17e)
TRACE_STEPS = 3
# epochs timed a side, alternating, from the host loader and the cache (17d)
EPOCH_RUNS = 4


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG (one IDAT, no row filter) written with zlib and
    struct alone: the machine with the card has no image encoder."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def check_png_input(root: str, smi: str) -> dict:
    """17a: two of phase 4's slides as PNG directories with their
    ``loc.txt``; the C++ loader's decode of them against the shard rows (bit
    for bit), ``pack_patches`` on them against the rows; the host read of a
    batch of 16 bags x 16 from the shards through the assembler and through
    the thread pool it replaced (batches equal), ``HOST_READ_RUNS`` turns a
    side, and the assembler's decode of the PNG slides' batch."""
    png_root = os.path.join(root, "png_patches")
    for wsi in PNG_SLIDES:
        d = os.path.join(png_root, wsi)
        os.makedirs(d)
        shutil.copy(os.path.join(root, "patches", wsi, "loc.txt"), d)
        rows = np.load(os.path.join(root, "patches", wsi, "patches.npy"))
        for j, rgb in enumerate(rows):
            write_png(os.path.join(d, f"{wsi}_patch_{j}.png"), rgb)
        paths = [os.path.join(d, f"{wsi}_patch_{j}.png") for j in range(N_PATCH)]
        decoded = np.zeros_like(rows)
        native.decode_patch_batch(paths, decoded, num_threads=8)
        if not np.array_equal(decoded, rows):
            raise AssertionError(f"{wsi}: the loader's PNG decode differs from the shard rows")
    pack_patches.main(["--patch_path", png_root])
    for wsi in PNG_SLIDES:
        packed = np.load(os.path.join(png_root, wsi, "patches.npy"))
        if not np.array_equal(packed, np.load(os.path.join(root, "patches", wsi, "patches.npy"))):
            raise AssertionError(f"{wsi}: pack_patches differs from the shard rows")
        os.remove(os.path.join(png_root, wsi, "patches.npy"))  # read the PNGs below

    ds = PatchBagDataset(os.path.join(root, "patches"), os.path.join(root, "cohort.csv"),
                         img_size=IMG, bag_size=BAG, max_patches_total=N_PATCH)
    idx = np.arange(B)
    with ThreadPoolExecutor(max_workers=8) as pool:
        a, p = ds._load_batch(idx, B, 8), ds._load_batch_plain(idx, B, pool)
        if not all(np.array_equal(a[k], p[k]) for k in ("patch_bag", "bag_mask", "sample_mask")):
            raise AssertionError("the assembler's batch differs from the thread pool's")
        times = {"assembler": [], "thread_pool": []}
        for r in range(HOST_READ_RUNS):
            order = ("assembler", "thread_pool") if r % 2 == 0 else ("thread_pool", "assembler")
            for name in order:
                times[name].append(_ms(
                    (lambda: ds._load_batch(idx, B, 8)) if name == "assembler"
                    else (lambda: ds._load_batch_plain(idx, B, pool))))
    png_csv = os.path.join(root, "png_cohort.csv")
    with open(os.path.join(root, "cohort.csv")) as f:
        lines = f.read().splitlines()
    with open(png_csv, "w") as f:
        f.write("\n".join([lines[0]] + [ln for ln in lines[1:]
                                         if ln.split(",")[-1].split(".")[0] in PNG_SLIDES])
                + "\n")
    png_ds = PatchBagDataset(png_root, png_csv, img_size=IMG, bag_size=BAG,
                             max_patches_total=N_PATCH)
    png_idx = np.arange(len(png_ds))
    png_batch = png_ds._load_batch(png_idx, len(png_idx), 8)
    if not np.array_equal(png_batch["patch_bag"], ds._load_batch(png_idx, len(png_idx), 8)[
            "patch_bag"]):
        raise AssertionError("the PNG slides' batch differs from the shards'")
    png_ms = [_ms(lambda: png_ds._load_batch(png_idx, len(png_idx), 8))
              for _ in range(HOST_READ_RUNS)]
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"host read of {B} bags x {BAG} patches at {IMG} px from shards (warm page "
          f"cache, {HOST_READ_RUNS} turns a side): the C++ assembler median "
          f"{med['assembler']:.2f} ms (min {min(times['assembler']):.2f}), the thread pool "
          f"median {med['thread_pool']:.2f} ms (min {min(times['thread_pool']):.2f}); "
          f"{len(png_idx) * BAG} PNGs decoded by the assembler: median "
          f"{np.median(png_ms):.2f} ms [{smi}]")
    return {"host_read_ms_per_256": med, "host_read_runs_ms": times,
            "png_decode_ms_per_batch": float(np.median(png_ms)),
            "png_patches_per_batch": len(png_idx) * BAG}


def _check_table(path: str, rows: int, header: list[str]) -> dict:
    """A frame written by one of the late-fusion CLIs: its leading columns,
    ``rows`` rows, every numeric column finite."""
    frame = read_frame(path)
    if list(frame)[:len(header)] != header or n_rows(frame) != rows:
        raise AssertionError(f"{path}: columns {list(frame)[:6]}..., {n_rows(frame)} rows")
    for c, v in frame.items():
        if c != "case" and not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"{path}: column {c} is not finite")
    return frame


def drive_chained_pipeline(root: str, smi: str) -> tuple[dict, dict]:
    """17b: phase 15's cohort (8 slides, a 12,778-gene vector per case)
    through ``histo_savescore`` and ``histo_extractfeatures`` (phase 4's
    model, K1 counted) and ``rna_savescore`` and ``rna_extractfeatures``
    (phase 6's model); ``concat_features`` of their files into a table of
    4,096 ``feature_`` columns a split; ``feature_train`` for an epoch on it
    (K2a and K2b counted); ``merge_scores`` of the score frames into
    ``late_fusion``. Every frame checked."""
    joint_csv = os.path.join(root, "joint.csv")
    out = os.path.join(root, "chain")
    cases, info = [], {"case": [], "survival_months": [], "vital_status": []}
    for row in read_csv_rows(os.path.join(root, "cohort.csv")):
        if row["case"] not in cases:
            cases.append(row["case"])
            info["case"].append(row["case"])
            info["survival_months"].append(float(row["survival_months"]))
            info["vital_status"].append(int(row["vital_status"]))
    info_csv = os.path.join(root, "patientinfo.csv")
    write_frame(info_csv, info, index=False)
    n_cases = len(cases)
    split_batches = 3 * math.ceil(N_WSI * N_PATCH / BAG / B)
    _, histo_path = _config(root, joint_csv, "chain_histo", output_path=out)
    _, rna_path = _rna_config(root, {s: joint_csv for s in ("train", "val", "test")},
                              "chain_rna", checkpoint_path=os.path.join(root, "rna_ckpt"),
                              output_path=out)
    by_cli = {}
    for cli, main, path, expected in (
        ("chain_histo_savescore", histo_savescore.main, histo_path,
         {"attention_pool": split_batches}),
        ("chain_histo_extractfeatures", histo_extractfeatures.main, histo_path,
         {"attention_pool": split_batches}),
        ("chain_rna_savescore", rna_savescore.main, rna_path, {}),
        ("chain_rna_extractfeatures", rna_extractfeatures.main, rna_path, {}),
    ):
        by_cli[cli] = _run_counted(cli, main, path, expected, smi)
    features = {}
    for split in ("train", "val", "test"):
        features[split] = os.path.join(out, f"features_{split}.csv")
        concat_features.main([
            "--rna_cases", os.path.join(out, f"rna_cases_{split}.csv"),
            "--rna_features", os.path.join(out, f"rna_features_{split}.csv"),
            "--pathology_cases", os.path.join(out, f"pathology_cases_{split}.csv"),
            "--pathology_features", os.path.join(out, f"pathology_features_{split}.csv"),
            "--patientinfo", info_csv, "--output", features[split]])
        table = _check_table(features[split], n_cases,
                             ["case", "survival_months", "vital_status", "feature_0_x"])
        if sum(c.startswith("feature_") for c in table) != 2 * D or table["case"] != cases:
            raise AssertionError(f"{features[split]}: not {2 * D} feature columns")
    ckpt = os.path.join(root, "chain_early_ckpt")
    early = {"batch_size": EARLY_BATCH, "num_epochs": 1, "dropout": 0.5, "lr": 1e-5,
             "weight_decay": 1e-5, "flag": "chain_early", "checkpoint_path": ckpt,
             **{f"{split}_csv_path": path for split, path in features.items()}}
    early_path = os.path.join(root, "chain_early.json")
    with open(early_path, "w") as f:
        json.dump(early, f)
    by_cli["chain_feature_train"] = _run_counted(
        "chain_feature_train", feature_train.main, early_path,
        {k: n * math.ceil(n_cases / EARLY_BATCH) for k, n in EARLY_K2.items()}, smi)
    for split in ("train", "val", "test"):
        for tag in ("last", "best"):
            _check_frames(os.path.join(ckpt, "outputs", "chain_early",
                                       f"{split}_output_{tag}.csv"), n_cases)
    combined = {}
    for split in ("train", "val"):
        combined[split] = os.path.join(out, f"combined_score_{split}.csv")
        merge_scores.main([
            "--pathology_scores", os.path.join(out, f"model.pt_pathology_{split}_df.csv"),
            "--rna_scores", os.path.join(out, f"rna_{split}_df.csv"),
            "--output", combined[split]])
        _check_table(combined[split], n_cases, LATE_HEADER)
    late_dir = os.path.join(out, "late")
    by_cli["chain_late_fusion"] = _run_counted(
        "chain_late_fusion", late_fusion.main,
        ["--train_csv", combined["train"], "--val_csv", combined["val"],
         "--output_dir", late_dir], {}, smi)
    for split in ("train", "val"):
        _check_table(os.path.join(late_dir, f"model_late_{split}.csv"), n_cases,
                     LATE_HEADER + ["score"])
    print(f"chained pipeline: {n_cases} cases through the histo and RNA serving CLIs, "
          f"concat_features ({2 * D} feature columns), feature_train, merge_scores and "
          "late_fusion; every frame checked")
    return by_cli, {"cases": n_cases}


LATE_HEADER = ["case", "path_score", "survival_months", "vital_status", "rna_score"]


def make_late_frames(root: str) -> dict:
    """17c: seeded combined-score frames (``LATE_HEADER``): the two scores
    carry the risk with ``LATE_EFFECTS``, times on a 3-month grid."""
    rng = np.random.default_rng(LATE_SEED)
    paths = {}
    for split, n in LATE_SPLITS.items():
        risk = rng.normal(size=n)
        frame = {"case": [f"{split}{i}" for i in range(n)]}
        scores = {c: w * risk + rng.normal(size=n) * 0.7 for c, w in LATE_EFFECTS.items()}
        frame["path_score"] = scores["path_score"].tolist()
        frame["survival_months"] = (np.ceil(rng.exponential(40 * np.exp(-risk)) / 3) * 3
                                    ).tolist()
        frame["vital_status"] = (rng.uniform(size=n) > 0.4).astype(int).tolist()
        frame["rna_score"] = scores["rna_score"].tolist()
        paths[split] = os.path.join(root, f"late_{split}.csv")
        write_frame(paths[split], frame, index=False)
    return paths


def check_late_fusion_scale(root: str, device: torch.device, smi: str) -> dict:
    """17c: ``late_fusion`` on the card on train 600 / val 150 rows; the
    fit's time, its CUDA graph replays and its kernels (a profiler count of
    a second fit); the same fit on the CPU: λ.min equal, β and the CV curve
    within ``COXNET_TOL`` of their scale."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    paths = make_late_frames(root)
    late_dir = os.path.join(root, "late_scale")
    t0 = time.perf_counter()
    res = late_fusion.main(["--train_csv", paths["train"], "--val_csv", paths["val"],
                            "--output_dir", late_dir])
    cli_s = time.perf_counter() - t0
    for split, n in LATE_SPLITS.items():
        _check_table(os.path.join(late_dir, f"model_late_{split}.csv"), n,
                     LATE_HEADER + ["score"])
    card = res["fit"]
    frame = read_frame(paths["train"])
    X = np.stack([frame[c] for c in LATE_EFFECTS], 1)
    t, e = np.asarray(frame["survival_months"]), np.asarray(frame["vital_status"])
    # the kernels of one graph replay (one λ's 500 steps over the fit's
    # batch of problems), from a profile of that replay alone: a profile of
    # the whole fit records ~5e5 kernels and takes minutes to read
    Xs = ((X - X.mean(0)) / X.std(0)).astype(np.float32)
    solver = FistaSolver(CoxProblems(Xs, t.astype(np.float32), e.astype(np.float32),
                                     np.ones((card.stats["problems"], len(t)), bool), device),
                         1.0, 500)
    solver.run(card.lambda_min)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.run(card.lambda_min)
        torch.cuda.synchronize()
    per_replay = sum(k.count for k in prof.key_averages() if k.device_type == DeviceType.CUDA
                     and not getattr(k, "is_user_annotation", False))
    kernels = card.stats["graph_replays"] * per_replay
    cpu = fit_coxnet(X, t, e, seed=0, device="cpu")
    best = [list(f.lambdas).index(f.lambda_min) for f in (card, cpu)]
    lowest = np.sort(cpu.cv_mean)[:2]
    beta_err = float(np.abs(card.betas_path - cpu.betas_path).max()
                     / np.abs(cpu.betas_path).max())
    cv_err = float(np.nanmax(np.abs(card.cv_mean - cpu.cv_mean)) / np.nanmax(cpu.cv_mean))
    print(f"late fusion at {LATE_SPLITS['train']} / {LATE_SPLITS['val']} rows: the CLI "
          f"{cli_s:.2f} s; the fit on the card {card.stats['seconds']:.3f} s "
          f"({card.stats['problems']} problems x {len(card.lambdas)} lambdas x 500 FISTA "
          f"steps, {card.stats['graph_replays']} CUDA graph launches of {per_replay} "
          f"kernels each, {kernels} kernels), on the CPU {cpu.stats['seconds']:.3f} s; lambda.min "
          f"index {best[0]} / {best[1]} (the CPU curve's two lowest points "
          f"{(lowest[1] - lowest[0]) / lowest[0]:.2e} apart), beta {beta_err:.2e} and "
          f"cv_mean {cv_err:.2e} of their scale apart; beta {card.beta} [{smi}]")
    if best[0] != best[1] or beta_err > COXNET_TOL or cv_err > COXNET_TOL:
        raise AssertionError("the coxnet fit on the card differs from the CPU's")
    if device.type == "cuda" and card.stats["graph_replays"] != len(card.lambdas):
        raise AssertionError(f"{card.stats['graph_replays']} graph replays")
    return {"cli_s": cli_s, "fit_s_card": card.stats["seconds"],
            "fit_s_cpu": cpu.stats["seconds"], "graph_replays": card.stats["graph_replays"],
            "kernels_per_replay": per_replay, "kernels_per_fit": kernels,
            "beta_err": beta_err, "cv_mean_err": cv_err,
            "lambda_min_index": best[0], "cv_gap": float((lowest[1] - lowest[0]) / lowest[0]),
            "beta": card.beta.tolist()}


def _epoch_rates(config: Config, device: torch.device, cached, smi: str) -> dict:
    """Phase 8's train epoch (its batches, its model at ``n_layers_to_train``
    2) from the host loader and from the cache, ``EPOCH_RUNS`` turns a side,
    each epoch timed from its first batch's read to its last step's end."""
    torch.manual_seed(SEED)
    model = build_mil_model(config).to(device, memory_format=torch.channels_last)
    adapter = MILAdapter(model=model, device=device, augment=True)
    optimizer = wrap_optimizer(build_grouped_optimizer(
        model, [("train", mil_freeze_ladder(2), HISTO_LR)], 1e-4))
    settings = TrainSettings(batch_size=B)
    loss_fn, keys = make_loss_fn(TrainSettings())
    keys = adapter.array_keys + keys
    generator = torch.Generator(device=device).manual_seed(SEED)
    host = build_datasets(config, False)["train"]

    def epoch(ds, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in ds.batches(B, shuffle=True, seed=seed, num_threads=8):
            train_step(adapter, optimizer, loss_fn, adapter.to_device(batch, keys), settings,
                       generator)
        torch.cuda.synchronize()
        return len(ds) / (time.perf_counter() - t0)

    epoch(host, 0)
    epoch(cached, 0)
    rates = {"host": [], "cache": []}
    for r in range(EPOCH_RUNS):
        for name in (("host", "cache") if r % 2 == 0 else ("cache", "host")):
            rates[name].append(epoch(host if name == "host" else cached, r + 1))
    med = {k: float(np.median(v)) for k, v in rates.items()}
    print(f"histo train epoch ({len(host)} bags, {B} x {BAG} at {IMG} px, bf16, "
          f"n_layers_to_train 2): host loader median {med['host']:.1f} bags/s, device "
          f"cache median {med['cache']:.1f} bags/s ({EPOCH_RUNS} turns a side; the cache "
          f"{cached.nbytes} bytes, read {cached.read_seconds:.3f} s, uploaded "
          f"{cached.upload_seconds:.3f} s) [{smi}]")
    return {"bags_per_s": med, "bags_per_s_runs": rates}


def check_device_cache(root: str, device: torch.device, smi: str, k1_ms: dict
                       ) -> tuple[dict, dict]:
    """17d and 17e: phase 8's ``histo_train`` with ``cache_patches_on_device``
    and ``profile_steps`` (counted as phase 8's run; its weights against
    phase 8's within phase 12's tolerance; its trace holds the card's
    kernels); an epoch's bags/s from the host loader and from the cache; a
    cached train step's idle share at ``n_layers_to_train`` 2; ``joint_train``
    for an epoch from the cache (K2a and K2b counted)."""
    csv_path = os.path.join(root, "cohort.csv")
    keys = _histo_train_keys(root, "histo_cached_ckpt")
    cfg, cfg_path = _config(root, csv_path, "histo_cached", num_epochs=HISTO_EPOCHS,
                            cache_patches_on_device=True, profile_steps=TRACE_STEPS, **keys)
    by_cli = {"histo_train_cached": _run_counted(
        "histo_train_cached", histo_train.main, cfg_path,
        {"attention_pool": _k1_forwards(HISTO_EPOCHS),
         "attention_pool_backward": HISTO_EPOCHS * HISTO_BATCHES}, smi)}
    _check_train_outputs(cfg)
    want = torch.load(os.path.join(root, "histo_train_ckpt", "models", "histo_smoke",
                                   "model_last.pt"), weights_only=True)
    got = torch.load(os.path.join(cfg["checkpoint_path"], "models", "histo_smoke",
                                  "model_last.pt"), weights_only=True)
    diff = 0.0
    for k, v in want.items():
        if not v.is_floating_point():
            if not torch.equal(got[k], v):
                raise AssertionError(f"cached run's {k}: {got[k]} != {v}")
            continue
        diff = max(diff, (got[k] - v).abs().max().item())
        if not torch.allclose(got[k], v, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"cached run's {k} differs from phase 8's by "
                                 f"{(got[k] - v).abs().max().item():.3e}")
    trace_dir = os.path.join(cfg["checkpoint_path"], "models", "histo_smoke", "torch_trace")
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"{trace_dir}: {os.listdir(trace_dir)}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    if not kernels and device.type == "cuda":
        raise AssertionError(f"{traces[0]} holds no CUDA kernel events")
    trace = {"file": os.path.basename(traces[0]), "mb": os.path.getsize(traces[0]) / 1e6,
             "kernel_events": len(kernels),
             "kernel_ms": sum(ev.get("dur", 0) for ev in kernels) / 1e3}
    print(f"cached histo_train: weights vs phase 8's host-loader run max_abs_diff "
          f"{diff:.3e}; trace {trace['file']} ({trace['mb']:.1f} MB, "
          f"{trace['kernel_events']} kernel events, {trace['kernel_ms']:.1f} ms of kernels "
          f"over {TRACE_STEPS} steps) [{smi}]")
    config = Config(cfg)
    cached = DeviceCachedPatchBags(build_datasets(config, False)["train"], device)
    e2e = {"histo_cached_max_abs_diff": diff, "trace": trace,
           "cache_bytes": cached.nbytes, "cache_read_s": cached.read_seconds,
           "cache_upload_s": cached.upload_seconds,
           "epoch": _epoch_rates(config, device, cached, smi),
           "cached_train_step": check_histo_train_step(config, device, smi, 2, k1_ms,
                                                       cached=cached)}
    del cached
    jcfg, jcfg_path = _joint_config(root, os.path.join(root, "joint.csv"), "joint_cached",
                                    num_epochs=1, cache_patches_on_device=True)
    by_cli["joint_train_cached"] = _run_counted(
        "joint_train_cached", joint_train.main, jcfg_path,
        {k: n * JOINT_BATCHES for k, n in JOINT_K2.items()}, smi)
    for split in ("train", "val", "test"):
        for tag in ("last", "best"):
            _check_frames(os.path.join(jcfg["checkpoint_path"], "outputs", "joint_smoke",
                                       f"{split}_output_{tag}.csv"), N_WSI)
    return by_cli, e2e


def drive_phase17(root: str, device: torch.device, smi: str, k1_ms: dict
                  ) -> tuple[dict, dict]:
    """Phase 17 (a-e); returns its counted runs and its numbers."""
    t0 = time.perf_counter()
    e2e = {"png_input": check_png_input(root, smi)}
    by_cli, e2e["chained"] = drive_chained_pipeline(root, smi)
    e2e["late_fusion"] = check_late_fusion_scale(root, device, smi)
    cached_runs, e2e["device_cache"] = check_device_cache(root, device, smi, k1_ms)
    by_cli.update(cached_runs)
    e2e["seconds"] = time.perf_counter() - t0
    print(f"phase 17: {e2e['seconds']:.1f} s")
    return by_cli, e2e


# --- phases 18-19: whole-slide streaming, exported serving ---------------------

# the streaming slide (18): a white square with a noisy tissue square inside,
# about 1,700 tissue tiles; a PNG, and a 2-level deflate-tiled TIFF written by
# the port's writer (256-px tiles; its second level is the PNG reader's
# thumbnail, every 10th pixel, so both give the same tissue mask)
STREAM_SLIDE_PX, STREAM_TISSUE = 10240, (512, 9728)
TIFF_TILE, TIFF_LOW = 256, 10
# the JPEG-tiled fixture (18a): an Aperio-style pyramid and its digests; the
# JPEG 2000 fixtures (18c) beside it, under fixture.json's "j2k"
JPEG_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                            "torch_tiff")
# the assembled JPEG 2000 slide (18c): the streaming slide's size, its level 0
# a mosaic of the 33003 fixture's own 240-px codestreams, its level 1 every
# J2K_LOW-th pixel (the fixture's level-1 pixels, deflate-tiled)
J2K_FIXTURE, J2K_LOW = "aperio_j2k.svs", 4
STREAM_ARCH, STREAM_IMG, STREAM_BATCH = "resnet50", IMG, 128
# the JAX default cap on tiles a slide, and the least the slide must give
STREAM_MAX_PATCHES, STREAM_MIN_TILES = 2000, 1500
# the runs cut to these many tiles (the host's tiling, about 6 ms a tile,
# sets their time): the deflate TIFF's and the joint ones; the PNG's folded,
# int8 and float runs take the whole slide, the float one timed
STREAM_CUT_PATCHES = {"tiff": 256, "joint": 512}
# regions of the deflate TIFF read back against the slide's pixels before
# it streams, (x, y, w, h): inside a tile, across four, past the corner
TIFF_READBACK = ((3000, 3000, 224, 224), (7 * TIFF_TILE - 100, 9 * TIFF_TILE - 50, 300, 300),
                 (STREAM_SLIDE_PX - 150, STREAM_SLIDE_PX - 100, 400, 300))
# card vs CPU and the two-step route: the first tiles only
STREAM_CHECK_PATCHES = 32
# the histo card-vs-CPU tolerance (phases 5, 9): rtol, atol
STREAM_TOL = (1e-3, 1e-4)
# K1 at the slide tail's shape: one bag of 2,048 patches
SLIDE_TAIL_SHAPE = (1, 2048, D)
# exported serving (19): requests a model, their batch sizes 1-8, bags of
SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_BAG = 20, 8, 16
SERVE_BUCKETS = "1,8"
# served program vs the eager model, err / max|eager|: bf16 paths round at
# the same places (2**-6: the folded tolerance of phase 5); int8 and float32
# paths run the same kernels on the same qtree (float32 sums in another order)
SERVE_TOL = {"bfloat16": 2**-6, "int8": 1e-3, "float32": 1e-4}


def _k3_per_batch(arch: str) -> dict:
    """K3's launches for one batch through the int8 ``arch``: every conv
    but the stem (each block's last in the residual form), one stem pass."""
    blocks = sum(quantize.STAGE_SIZES[arch])
    basic = arch in quantize.BASIC_ARCHS
    convs = blocks * (2 if basic else 3) + (3 if basic else 4)
    return {"qmm_requant": convs, "qconv_residual_requant": blocks, "stem_requant_pool": 1}


def _k4_per_batch(arch: str) -> int:
    """K4's launches for one batch through the folded ``arch``: layer1's
    blocks and layer2's stride-1 tail (a BasicBlock ResNet: none)."""
    if arch in quantize.BASIC_ARCHS:
        return 0
    return quantize.STAGE_SIZES[arch][0] + quantize.STAGE_SIZES[arch][1] - 1


def _expected(attention: int = 0, k3_batches: int = 0, k4_batches: int = 0,
              arch: str = STREAM_ARCH) -> dict:
    want = {name: 0 for name in COUNT_NAMES}
    want["attention_pool"] = attention
    for name, n in _k3_per_batch(arch).items():
        want[name] = n * k3_batches
    want["fused_bottleneck_stage"] = _k4_per_batch(arch) * k4_batches
    return want


def write_stream_slide(path: str, seed: int = SEED) -> np.ndarray:
    """The streaming slide as a PNG (zlib's stored blocks); returns its
    pixels."""
    rng = np.random.default_rng(seed)
    lo, hi = STREAM_TISSUE
    img = np.full((STREAM_SLIDE_PX, STREAM_SLIDE_PX, 3), 255, np.uint8)
    noise = rng.integers(0, 60, size=(hi - lo, hi - lo, 3), dtype=np.uint8)
    img[lo:hi, lo:hi] = np.array([200, 120, 160], np.uint8) - noise // 2
    tiler.write_png(path, img, level=0)  # stored: quick to write and to read
    return img


def _stream_models(root: str) -> dict:
    """Seeded weights of the streaming and serving models: the MIL model
    (ResNet-50, attention 2048, bf16), the joint model (ResNet-50 and the
    RNA encoder, 12,778 genes) and the RNA MLP, as ``.pt`` files."""
    d = os.path.join(root, "stream")
    os.makedirs(d, exist_ok=True)
    base = {"model_name": STREAM_ARCH, "aggregator": "attention", "aggregator_hdim": D,
            "compute_dtype": "bfloat16", "num_classes": 1}
    paths = {k: os.path.join(d, f"{k}.pt") for k in ("mil", "joint", "rna")}
    if not os.path.isfile(paths["mil"]):
        torch.save(random_state_dict(build_mil_model(Config(base)), SEED + 18), paths["mil"])
        torch.save(random_state_dict(joint_train.build_joint_model(Config(base)), SEED + 19),
                   paths["joint"])
        torch.save(random_state_dict(rna_train.build_rna_model(Config({})), SEED + 20),
                   paths["rna"])
    return paths


def _stream_config(root: str, name: str, **overrides) -> tuple[dict, str]:
    d = os.path.join(root, "stream")
    cfg = {"model_name": STREAM_ARCH, "aggregator": "attention", "aggregator_hdim": D,
           "compute_dtype": "bfloat16", "num_classes": 1, "img_size": STREAM_IMG,
           "batch_size": STREAM_BATCH, "max_patches_per_slide": STREAM_MAX_PATCHES,
           "slides": [os.path.join(d, "wsi", "slide.png")], "save_patch_features": True,
           "model_path": os.path.join(d, "mil.pt"), "output_path": os.path.join(d, name),
           "flag": "stream_smoke", "num_workers": 8}
    cfg.update(overrides)
    path = os.path.join(d, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _check_slide_frames(cfg: dict, n: int | None = None, sid: str = "slide") -> int:
    """slide_extractfeatures' frames for one slide (id ``sid``); returns its
    tiles."""
    out = cfg["output_path"]
    scores = read_frame(os.path.join(out, "slide_scores.csv"))
    if list(scores) != ["slide", "case", "n_patches", "score"] or n_rows(scores) != 1:
        raise AssertionError(f"{out}/slide_scores.csv: {list(scores)}")
    tiles = scores["n_patches"][0]
    if (n is not None and tiles != n) or not np.isfinite(scores["score"][0]):
        raise AssertionError(f"{out}: {tiles} tiles (want {n}), score {scores['score']}")
    feats = np.loadtxt(os.path.join(out, "pathology_features_slides.csv"), delimiter=",")
    cases = read_frame(os.path.join(out, "pathology_cases_slides.csv"))
    if feats.shape != (D,) or not np.isfinite(feats).all() or n_rows(cases) != 1:
        raise AssertionError(f"{out}: features {feats.shape}, cases {cases}")
    if cfg.get("save_patch_features"):
        pf = np.load(os.path.join(out, "patch_features", f"{sid}_features.npy"))
        patches = read_frame(os.path.join(out, "patch_features", f"{sid}_patches.csv"))
        att = np.asarray(patches["attention"])
        if (pf.shape != (tiles, D) or list(patches) != ["id", "x", "y", "attention"]
                or n_rows(patches) != tiles or not np.isfinite(pf).all()
                or abs(att.sum() - 1) > 1e-3):
            raise AssertionError(f"{out}: patch features {pf.shape}, "
                                 f"patches {list(patches)} x {n_rows(patches)}")
    return tiles


def _check_joint_slide_frame(cfg: dict, n: int) -> None:
    path = os.path.join(cfg["output_path"], "joint_slide_scores.csv")
    frame = read_frame(path)
    if (list(frame) != ["slide", "case", "n_patches", "score", "survival_months",
                        "vital_status"] or n_rows(frame) != 1 or frame["n_patches"][0] != n
            or not np.isfinite(frame["score"][0])):
        raise AssertionError(f"{path}: {frame}")


def write_deflate_slide(path: str, img: np.ndarray) -> dict:
    """The streaming slide as a 2-level deflate-tiled TIFF from the port's
    writer (``data/tiff.py``); its write time and size."""
    t0 = time.perf_counter()
    tiff.write_tiff(path, [
        tiff.image_directory(img, tile=TIFF_TILE, compression=tiff.DEFLATE,
                             description="Aperio Image|AppMag = 20"),
        tiff.image_directory(img[::TIFF_LOW, ::TIFF_LOW], tile=TIFF_TILE,
                             compression=tiff.DEFLATE)])
    out = {"write_s": time.perf_counter() - t0, "bytes": os.path.getsize(path)}
    print(f"streaming slide as a deflate-tiled TIFF ({TIFF_TILE}-px tiles, levels "
          f"{STREAM_SLIDE_PX} and {STREAM_SLIDE_PX // TIFF_LOW} px): {json.dumps(out)}")
    return out


def check_tiff_readback(path: str, img: np.ndarray) -> None:
    """The port's ``TiffSlide`` reads the deflate TIFF back bit for bit:
    its lower level whole (the tissue mask's input) and ``TIFF_READBACK``'s
    level-0 regions, zeros past the edge."""
    slide = tiler.TiffSlide(path)
    low = img[::TIFF_LOW, ::TIFF_LOW]
    if not np.array_equal(slide.read_region((0, 0), 1, low.shape[1::-1]), low):
        raise AssertionError(f"{path}: level 1 is not the slide's every {TIFF_LOW}th pixel")
    for x, y, w, h in TIFF_READBACK:
        want = np.zeros((h, w, 3), np.uint8)
        part = img[y:y + h, x:x + w]
        want[:part.shape[0], :part.shape[1]] = part
        if not np.array_equal(slide.read_region((x, y), 0, (w, h)), want):
            raise AssertionError(f"{path}: level 0 at {(x, y, w, h)} is not the slide's pixels")
    print(f"deflate TIFF read back bit for bit: level 1 whole, level 0 at {TIFF_READBACK}")


def _check_digests(path: str, meta: dict, whose: str) -> dict:
    """The fixture slide at ``path`` through ``open_slide`` (the port's
    ``TiffSlide``): every level and associated image of ``meta`` (an entry
    of ``fixture.json``) at its digest; the names checked and the seconds
    the decode took."""
    t0 = time.perf_counter()
    slide = tiler.open_slide(path)
    if not isinstance(slide, tiler.TiffSlide):
        raise AssertionError(f"{path} opened as {type(slide).__name__}, not the port's TiffSlide")
    if slide.level_dimensions != [tuple(lv["size"]) for lv in meta["levels"]]:
        raise AssertionError(f"{path}: levels {slide.level_dimensions}, fixture {meta['levels']}")
    got = {f"level {i}": hashlib.sha256(slide.read_region(
        (0, 0), i, tuple(lv["size"])).tobytes()).hexdigest() for i, lv in enumerate(meta["levels"])}
    want = {f"level {i}": lv["sha256"] for i, lv in enumerate(meta["levels"])}
    for name, img in slide.associated_images.items():
        got[name] = hashlib.sha256(img.tobytes()).hexdigest()
    want.update({name: a["sha256"] for name, a in meta["associated"].items()})
    decode_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"{path}: digests {got}, {whose} {want}")
    return {"digests": sorted(got), "decode_s": decode_s}


def check_jpeg_fixture(path: str, smi: str) -> dict:
    """18a: the committed JPEG-tiled fixture through the port's reader:
    every level and associated image at the digests of libjpeg's decode
    (``tests/data/torch_tiff/fixture.json``)."""
    with open(os.path.join(JPEG_FIXTURE, "fixture.json")) as f:
        meta = json.load(f)
    out = _check_digests(path, meta, "libjpeg's")
    print(f"JPEG fixture {meta['slide']}: {out['digests']} at libjpeg's digests, decoded in "
          f"{out['decode_s']:.3f} s [{smi}]")
    return out


def check_slide_tail_k1(device: torch.device, smi: str) -> dict:
    """K1 at the slide tail's shape (one bag of 2,048 patches, bf16) against
    its plain version (``KERNEL_TOL``), timed beside the plain version and
    ``torch.matmul`` of the (2048 x 2048) · (2048 x 2048) product."""
    n_b, bag, d = SLIDE_TAIL_SHAPE
    g = torch.Generator(device="cpu").manual_seed(SEED + 18)
    x = torch.randn(n_b, bag, d, generator=g).relu().to(device, torch.bfloat16)
    weight = (torch.randn(d, d, generator=g) / math.sqrt(d)).to(device, torch.bfloat16)
    v = (torch.randn(d, generator=g) * 0.05).to(device)
    mask = torch.ones(n_b, bag, dtype=torch.bool, device=device)
    pooled, w = attention_pool(x, weight, v, mask)
    want_pooled, want_w = attention_pool_plain(x, weight, v, mask)
    err = max((pooled - want_pooled).abs().max().item(), (w - want_w).abs().max().item())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"K1 at {SLIDE_TAIL_SHAPE} disagrees with its plain version: "
                             f"{err} > {KERNEL_TOL}")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    x2d = x.view(-1, d)
    fns = {"kernel": lambda: attention_pool(x, weight, v, mask),
           "plain": lambda: attention_pool_plain(x, weight, v, mask),
           "library": lambda: torch.matmul(x2d, weight.t())}
    times = {k: [] for k in fns}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        times[name].append(_time_ms(fns[name], 25, scrub))
    bound_ms, bound_by = _bound(x, weight, v, mask)
    out = {"shape": list(SLIDE_TAIL_SHAPE), "dtype": "bfloat16", "max_abs_err": err,
           "ms": sum(times["kernel"]) / 2, "plain_ms": sum(times["plain"]) / 2,
           "library_ms": sum(times["library"]) / 2, "bound_ms": bound_ms,
           "bound_by": bound_by}
    print(f"K1 at the slide tail {SLIDE_TAIL_SHAPE} bf16: {json.dumps(out)} [{smi}]")
    return out


def _run_timed_stream(cli: str, cfg_path: str, expected, smi: str) -> tuple[dict, dict]:
    """``_run_counted`` of a one-slide ``slide_extractfeatures`` run, timed
    as it runs (its launches counted as every run's): from the slide's open
    to the tail's end, host tiling (and its share of that wall clock), the
    TIFF codecs' decode within it (each ``codecs.decode_blocks`` call, per
    decoded block and per tile), the encoder's device time (CUDA events),
    the tail's, tiles/s and the card's idle share (1 - device time / wall).
    Returns the run's record and the breakdown."""
    sx = slide_extractfeatures
    timing: dict = {}
    marks: dict = {}
    decode = {"s": 0.0, "blocks": 0}
    real = (sx.open_slide, sx.stream_slide_features, sx.make_slide_tail, codecs.decode_blocks)

    def open_slide(path):
        torch.cuda.synchronize()
        marks["t0"] = time.perf_counter()
        slide = real[0](path)
        marks["open_s"] = time.perf_counter() - marks["t0"]
        marks["slide"] = os.path.basename(path)
        return slide

    def stream(*args, **kwargs):
        return real[1](*args, timing=timing, **kwargs)

    def make_tail(model):
        tail = real[2](model)

        def timed_tail(feats):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = tail(feats)
            end.record()
            torch.cuda.synchronize()
            marks["wall_s"] = time.perf_counter() - marks["t0"]
            marks["tail_ms"] = start.elapsed_time(end)
            marks["tiles"] = feats.shape[0]
            return out

        return timed_tail

    def timed_decode(*args, **kwargs):
        t = time.perf_counter()
        out = real[3](*args, **kwargs)
        decode["s"] += time.perf_counter() - t
        decode["blocks"] += len(out[1])
        return out

    sx.open_slide, sx.stream_slide_features, sx.make_slide_tail = open_slide, stream, make_tail
    codecs.decode_blocks = timed_decode
    try:
        run = _run_counted(cli, sx.main, cfg_path, expected, smi)
    finally:
        sx.open_slide, sx.stream_slide_features, sx.make_slide_tail = real[:3]
        codecs.decode_blocks = real[3]
    n, wall = marks["tiles"], marks["wall_s"]
    out = {"slide": marks["slide"], "tiles": n, "wall_s": wall, "tiles_per_s": n / wall,
           "open_s": marks["open_s"], "host_tiling_s": timing["tile_s"],
           "host_share": timing["tile_s"] / wall, "host_wait_s": timing["wait_s"],
           "decode_s": decode["s"], "decoded_blocks": decode["blocks"],
           "decode_ms_per_block": 1e3 * decode["s"] / max(1, decode["blocks"]),
           "decode_ms_per_tile": 1e3 * decode["s"] / n,
           "encoder_s": timing.get("encode_ms", 0.0) / 1e3, "tail_s": marks["tail_ms"] / 1e3,
           "batches": timing["batches"]}
    out["idle_share"] = 1 - (out["encoder_s"] + out["tail_s"]) / wall
    print(f"streaming breakdown ({cli}, {out['slide']}, {n} tiles, batch {STREAM_BATCH}): "
          f"{json.dumps(out)} [{smi}]")
    return run, out


def _same_streamed_tiles(cfg: dict, ref: dict) -> int:
    """A streamed run of ``ref``'s pixels cut shorter: its tiles are the
    first of ``ref``'s, at the same positions, with the same patch features
    bit for bit (lossless blocks, the same batches); returns its tiles."""
    def load(c):
        out = os.path.join(c["output_path"], "patch_features")
        frame = read_frame(os.path.join(out, "slide_patches.csv"))
        return (list(zip(frame["x"], frame["y"])),
                np.load(os.path.join(out, "slide_features.npy")))

    (locs, feats), (ref_locs, ref_feats) = load(cfg), load(ref)
    k = len(locs)
    if locs != ref_locs[:k]:
        raise AssertionError(f"{cfg['output_path']}: tiles differ from {ref['output_path']}'s")
    if not np.array_equal(feats, ref_feats[:k]):
        raise AssertionError(f"{cfg['output_path']}: features differ from "
                             f"{ref['output_path']}'s first {k} by "
                             f"{float(np.abs(feats - ref_feats[:k]).max())}")
    print(f"{cfg['output_path']} vs {ref['output_path']}: its {k} tiles are the first "
          f"{k} of {len(ref_locs)}, at the same positions, with the same features bit for bit")
    return k


def _two_step_route(root: str, name: str, wsi_dir: str, ext: str, streamed: dict,
                    n: int) -> float:
    """``wsi2patches`` → ``pack_patches`` → ``histo_extractfeatures``
    (float32) on the one slide in ``wsi_dir``, its first ``n`` tiles: the
    tiles of the streamed float32 run ``streamed`` and its slide embedding
    within ``STREAM_TOL``; returns the embedding's max abs diff."""
    d = os.path.join(root, "stream")
    patch_root, mask_root = os.path.join(d, f"{name}_patches"), os.path.join(d, f"{name}_masks")
    wsi2patches.main(["--wsi_path", wsi_dir, "--patch_path", patch_root,
                      "--mask_path", mask_root, "--patch_size", str(STREAM_IMG),
                      "--max_patches_per_slide", str(n), "--num_process", "1", "--ext", ext])
    pack_patches.main(["--patch_path", patch_root])
    (sid,) = os.listdir(patch_root)
    with open(os.path.join(patch_root, sid, "loc.txt")) as f:
        loc = [tuple(int(v) for v in line.split()[1:3]) for line in f.read().splitlines()[2:]]
    frame = read_frame(os.path.join(streamed["output_path"], "patch_features",
                                    f"{sid}_patches.csv"))
    if loc != list(zip(frame["x"], frame["y"])):
        raise AssertionError(f"the streamed tiles of {sid} are not wsi2patches' tiles")
    cohort = os.path.join(d, f"{name}.csv")
    with open(cohort, "w") as f:
        f.write(f"case,survival_months,vital_status,wsi_file_name\n{sid},37.5,1,{sid}.svs\n")
    cfg, path = _stream_config(
        root, name, compute_dtype="float32", data_path=patch_root,
        train_csv_path=cohort, val_csv_path=cohort, test_csv_path=cohort, batch_size=1,
        train_bag_size=n, val_bag_size=n, max_patch_per_wsi_train=n, max_patch_per_wsi_val=n)
    histo_extractfeatures.main(["--config", path])
    two_step = np.loadtxt(os.path.join(cfg["output_path"], "pathology_features_test.csv"),
                          delimiter=",")
    streamed_emb = np.loadtxt(os.path.join(streamed["output_path"],
                                           "pathology_features_slides.csv"), delimiter=",")
    diff = float(np.abs(two_step - streamed_emb).max())
    if not np.allclose(two_step, streamed_emb, rtol=STREAM_TOL[0], atol=STREAM_TOL[1]):
        raise AssertionError(f"{sid}: streamed vs two-step slide embedding: max_abs_diff {diff}")
    print(f"{sid}: streaming vs two-step route ({len(loc)} tiles): positions equal, slide "
          f"embedding max_abs_diff {diff:.3e}")
    return diff


def _stream_fixture(root: str, smi: str, runs: dict, name: str, key: str, check) -> dict:
    """A committed fixture slide ``name`` (copied alone into a directory of
    its own) checked by ``check(path, smi)``, streamed whole through
    ``slide_extractfeatures`` (bf16, counted: K1 once) and in float32
    against the two-step route."""
    wsi = os.path.join(root, "stream", f"wsi_{key}")
    os.makedirs(wsi, exist_ok=True)
    path = os.path.join(wsi, name)
    shutil.copyfile(os.path.join(JPEG_FIXTURE, name), path)
    out = check(path, smi)
    sid = tiler.slide_id_for(path)
    cfg, cfg_path = _stream_config(root, f"{key}_slide", slides=[path])
    tiles = {}

    def expect(cfg=cfg):
        tiles["n"] = _check_slide_frames(cfg, sid=sid)
        return _expected(attention=1)

    runs[f"slide_extractfeatures_{key}"] = _run_counted(
        f"slide_extractfeatures {key} fixture", slide_extractfeatures.main, cfg_path, expect,
        smi)
    cfg32, path32 = _stream_config(root, f"{key}_slide_f32", slides=[path],
                                   compute_dtype="float32")
    slide_extractfeatures.main(["--config", path32])
    out["tiles"] = _check_slide_frames(cfg32, tiles["n"], sid)
    out["two_step_max_abs_diff"] = _two_step_route(root, f"{key}_two_step", wsi, "svs", cfg32,
                                                   out["tiles"])
    return out


def drive_jpeg_fixture(root: str, smi: str, runs: dict) -> dict:
    """18a: the committed JPEG-tiled ``.svs`` (240-px 4:2:0 tiles under
    Photometric RGB, Aperio's layout) decoded to its digests, streamed whole
    through ``slide_extractfeatures`` (bf16, counted: K1 once) and in
    float32 against the two-step route."""
    with open(os.path.join(JPEG_FIXTURE, "fixture.json")) as f:
        name = json.load(f)["slide"]
    return _stream_fixture(root, smi, runs, name, "jpeg", check_jpeg_fixture)


def check_j2k_fixtures(smi: str) -> dict:
    """18c: both committed JPEG 2000 fixtures (33003: 9/7, YCbCr samples;
    33005: 5/3, RGB) through ``open_slide`` and the port's own decoder
    (the machine with the card has no Pillow): every level and associated
    image at the digests of the JAX reader's decode (``fixture.json``'s
    ``"j2k"``)."""
    with open(os.path.join(JPEG_FIXTURE, "fixture.json")) as f:
        fixtures = json.load(f)["j2k"]
    out = {}
    for meta in fixtures:
        got = out[meta["slide"]] = _check_digests(os.path.join(JPEG_FIXTURE, meta["slide"]),
                                                  meta, "the JAX reader's")
        print(f"JPEG 2000 fixture {meta['slide']} ({meta['compression']}): {got['digests']} "
              f"at the JAX reader's digests, decoded in {got['decode_s']:.3f} s [{smi}]")
    return out


def write_j2k_stream_slide(path: str) -> dict:
    """The streaming slide's size as an Aperio 33003 pyramid assembled from
    the J2K fixture's own codestreams (raw blocks: no encoder here). Level
    0: 240-px tiles, the fixture's whole-tissue tiles (in turn) over
    ``STREAM_TISSUE``'s square and its white corner tile elsewhere; level 1
    (every ``J2K_LOW``-th pixel, the tissue mask's input): the same mosaic
    of the fixture's decoded level-1 pixels, deflate-tiled."""
    t0 = time.perf_counter()
    with open(os.path.join(JPEG_FIXTURE, "fixture.json")) as f:
        meta = json.load(f)
    src = os.path.join(JPEG_FIXTURE, J2K_FIXTURE)
    d0, d1 = [d for d in tiff.read_directories(src) if d.tiled]
    tile, nx = d0.tile[0], d0.grid[0]
    if d0.width != J2K_LOW * d1.width or tile % J2K_LOW:
        raise AssertionError(f"{src}: level 1 is not every {J2K_LOW}th pixel of level 0")
    with open(src, "rb") as f:
        raw = f.read()
    low_src = tiler.TiffSlide(src).read_region((0, 0), 1, (d1.width, d1.height))
    lo_px, hi_px = meta["tissue"]
    inner = range(-(-lo_px // tile), hi_px // tile)  # the fixture's whole-tissue tiles
    n = -(-STREAM_SLIDE_PX // tile)
    lo, hi = -(-STREAM_TISSUE[0] // tile), STREAM_TISSUE[1] // tile
    blocks, lt = [], tile // J2K_LOW
    low = np.zeros((n * lt, n * lt, 3), np.uint8)
    for i in range(n):
        for j in range(n):
            a, b = ((inner[i % len(inner)], inner[j % len(inner)])
                    if lo <= i < hi and lo <= j < hi else (0, 0))
            k = a * nx + b
            blocks.append(raw[d0.offsets[k]:d0.offsets[k] + d0.counts[k]])
            low[i * lt:(i + 1) * lt, j * lt:(j + 1) * lt] = low_src[a * lt:(a + 1) * lt,
                                                                    b * lt:(b + 1) * lt]
    side = STREAM_SLIDE_PX // J2K_LOW
    tiff.write_tiff(path, [
        tiff.DirectorySpec(STREAM_SLIDE_PX, STREAM_SLIDE_PX, blocks,
                           compression=tiff.APERIO_J2K_YCBCR, tile=(tile, tile),
                           description="Aperio Image|AppMag = 20"),
        tiff.image_directory(low[:side, :side], tile=TIFF_TILE, compression=tiff.DEFLATE)])
    out = {"write_s": time.perf_counter() - t0, "bytes": os.path.getsize(path),
           "tiles": n * n, "tissue_tiles": (hi - lo) ** 2}
    print(f"streaming slide as a 33003 pyramid from {J2K_FIXTURE}'s codestreams ({tile}-px "
          f"tiles, levels {STREAM_SLIDE_PX} and {side} px): {json.dumps(out)}")
    return out


def drive_j2k(root: str, smi: str, runs: dict, e2e: dict) -> dict:
    """18c: the JPEG 2000 fixtures at their digests; the 33003 one streamed
    whole (bf16, counted: K1 once) and in float32 against the two-step
    route; a 33003 slide of the streaming slide's size assembled from its
    codestreams, cut to ``STREAM_CUT_PATCHES["tiff"]`` tiles and timed as it
    runs, its decode ms a tile and a block, blocks a tile, tiles/s and idle
    share printed beside the deflate TIFF's and the PNG's (``e2e``)."""
    t0 = time.perf_counter()
    out = {"fixtures": check_j2k_fixtures(smi)}
    out["stream_fixture"] = _stream_fixture(root, smi, runs, J2K_FIXTURE, "j2k",
                                            lambda path, smi: {})
    wsi = os.path.join(root, "stream", "wsi_j2k_big")
    os.makedirs(wsi, exist_ok=True)
    path = os.path.join(wsi, "slide_j2k.svs")
    out["slide"] = write_j2k_stream_slide(path)
    cut = STREAM_CUT_PATCHES["tiff"]
    cfg, cfg_path = _stream_config(root, "slide_j2k", slides=[path], max_patches_per_slide=cut)

    def expect(cfg=cfg):
        _check_slide_frames(cfg, cut, sid="slide_j2k")
        return _expected(attention=1)

    runs["slide_extractfeatures_j2k_stream"], out["breakdown"] = _run_timed_stream(
        "slide_extractfeatures J2K (33003) slide", cfg_path, expect, smi)
    keys = ("tiles", "decode_ms_per_tile", "decode_ms_per_block", "tiles_per_s", "idle_share",
            "host_share")
    side = {}
    for name, b in (("j2k_33003", out["breakdown"]), ("deflate_tiff", e2e["breakdown_tiff"]),
                    ("png", e2e["breakdown"])):
        side[name] = {k: b[k] for k in keys}
        side[name]["blocks_per_tile"] = b["decoded_blocks"] / b["tiles"]
    out["side_by_side"] = side
    print(f"streamed slides side by side (decode ms a tile / a block, blocks a tile, "
          f"tiles/s, idle share): {json.dumps(side)} [{smi}]")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18 (c): {out['seconds']:.1f} s")
    return out


def drive_streaming(root: str, device: torch.device, smi: str) -> tuple[dict, dict]:
    """Phase 18: whole-slide streaming at full width (ResNet-50, attention
    2048, bf16, 224 px, up to 2,000 tiles): ``slide_extractfeatures`` in
    float, folded and int8 on the whole PNG and in float on the deflate-tiled
    TIFF (read back bit for bit; its tiles and features the PNG's first),
    ``slide_joint_savescore`` folded and int8, each counted and its frames
    checked; the two float runs timed as they run (the breakdowns); the
    card against the CPU over the first 32 tiles
    (float32), and the streamed tiles and features against the two-step
    route (``wsi2patches`` → ``pack_patches`` → ``histo_extractfeatures``);
    the JPEG-tiled fixture (18a); K1 at the slide tail's shape."""
    t_phase = time.perf_counter()
    d = os.path.join(root, "stream")
    for sub in ("wsi", "wsi_tiff"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    t0 = time.perf_counter()
    img = write_stream_slide(os.path.join(d, "wsi", "slide.png"))
    print(f"streaming slide: {STREAM_SLIDE_PX}x{STREAM_SLIDE_PX} px PNG in "
          f"{time.perf_counter() - t0:.1f} s")
    tiff_path = os.path.join(d, "wsi_tiff", "slide.tif")
    runs, e2e = {}, {"deflate_tiff": write_deflate_slide(tiff_path, img)}
    check_tiff_readback(tiff_path, img)
    del img
    models = _stream_models(root)

    def batches(n):
        return math.ceil(n / STREAM_BATCH)

    tiles = {}
    modes = {"folded": {"fold_bn": True}, "int8": {"quantize": "int8"}, "float": {}}
    for mode, keys in modes.items():
        cfg, path = _stream_config(root, f"slide_{mode}", **keys)

        def expect(cfg=cfg, mode=mode):
            n = tiles[mode] = _check_slide_frames(cfg)
            return _expected(attention=1, k3_batches=batches(n) if mode == "int8" else 0,
                             k4_batches=batches(n) if mode == "folded" else 0)

        name = f"slide_extractfeatures {mode}"
        if mode == "float":  # the PNG's breakdown
            runs["slide_extractfeatures_float"], e2e["breakdown"] = _run_timed_stream(
                name, path, expect, smi)
        else:
            runs[f"slide_extractfeatures_{mode}"] = _run_counted(
                name, slide_extractfeatures.main, path, expect, smi)
    n = e2e["tiles"] = tiles["float"]  # the whole slide's
    if n < STREAM_MIN_TILES or tiles["int8"] != n or tiles["folded"] != n:
        raise AssertionError(f"tiles a run: {tiles} (the same tiler: one count, "
                             f">= {STREAM_MIN_TILES})")
    # the deflate-tiled TIFF, cut and timed: the PNG's pixels, so the
    # first tiles and features of the PNG's float run
    cut = min(n, STREAM_CUT_PATCHES["tiff"])
    cfg_tiff, path = _stream_config(root, "slide_tiff", slides=[tiff_path],
                                    max_patches_per_slide=cut)

    def expect_tiff(cfg=cfg_tiff):
        _check_slide_frames(cfg, cut)
        return _expected(attention=1)

    runs["slide_extractfeatures_tiff"], e2e["breakdown_tiff"] = _run_timed_stream(
        "slide_extractfeatures deflate TIFF", path, expect_tiff, smi)
    e2e["tiff_vs_png_tiles"] = _same_streamed_tiles(cfg_tiff,
                                                    _stream_config(root, "slide_float")[0])
    # the joint model on the same slide with a 12,778-gene RNA row
    rng = np.random.default_rng(SEED + 21)
    joint_csv = os.path.join(d, "joint_slides.csv")
    with open(joint_csv, "w") as f:
        f.write("case,survival_months,vital_status,wsi_file_name,"
                + ",".join(f"rna_{i}" for i in range(RNA_GENES)) + "\n")
        f.write("c0,37.5,1,slide.png," + ",".join(
            "%.5g" % v for v in rng.standard_normal(RNA_GENES, dtype=np.float32)) + "\n")
    for mode, keys in (("folded", {"fold_bn": True}), ("int8", {"quantize": "int8"})):
        cut = min(n, STREAM_CUT_PATCHES["joint"])
        cfg, path = _stream_config(root, f"joint_slide_{mode}", slide_csv_path=joint_csv,
                                   slide_path=os.path.join(d, "wsi"),
                                   model_path=models["joint"], max_patches_per_slide=cut,
                                   **keys)

        def expect(cfg=cfg, mode=mode, cut=cut):
            _check_joint_slide_frame(cfg, cut)
            return _expected(k3_batches=batches(cut) if mode == "int8" else 0,
                             k4_batches=batches(cut) if mode == "folded" else 0)

        runs[f"slide_joint_savescore_{mode}"] = _run_counted(
            f"slide_joint_savescore {mode}", slide_joint_savescore.main, path, expect, smi)

    # the card against the CPU over the first tiles, float32
    small = {"compute_dtype": "float32", "max_patches_per_slide": STREAM_CHECK_PATCHES,
             "batch_size": STREAM_CHECK_PATCHES}
    cfg_card, card_path = _stream_config(root, "slide_f32_card", **small)
    cfg_cpu, cpu_path = _stream_config(root, "slide_f32_cpu", **small)
    slide_extractfeatures.main(["--config", card_path])
    slide_extractfeatures.main(["--config", cpu_path, "--device", "cpu"])
    diffs = {}
    for name, load in (("features", lambda c: np.load(os.path.join(
                           c["output_path"], "patch_features", "slide_features.npy"))),
                       ("score", lambda c: np.asarray(read_frame(os.path.join(
                           c["output_path"], "slide_scores.csv"))["score"]))):
        got, want = load(cfg_card), load(cfg_cpu)
        diffs[name] = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=STREAM_TOL[0], atol=STREAM_TOL[1]):
            raise AssertionError(f"streamed {name}: card vs CPU max_abs_diff {diffs[name]}")
    print(f"streaming card vs CPU ({STREAM_CHECK_PATCHES} tiles, float32): max_abs_diff "
          f"{diffs} (rtol {STREAM_TOL[0]}, atol {STREAM_TOL[1]})")
    e2e["card_vs_cpu_max_abs_diff"] = diffs

    # the two-step route on the same slide and tiles
    e2e["two_step_max_abs_diff"] = _two_step_route(
        root, "two_step", os.path.join(d, "wsi"), "png", cfg_card, STREAM_CHECK_PATCHES)
    e2e["jpeg_fixture"] = drive_jpeg_fixture(root, smi, runs)
    e2e["slide_tail_k1"] = check_slide_tail_k1(device, smi)
    e2e["j2k"] = drive_j2k(root, smi, runs, e2e)
    e2e["seconds"] = time.perf_counter() - t_phase
    print(f"phase 18: {e2e['seconds']:.1f} s")
    return runs, e2e


def _post(port: int, path: str, body: dict) -> tuple[int, dict, float]:
    import http.client

    data = json.dumps(body).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    ms = (time.perf_counter() - t0) * 1e3
    conn.close()
    return resp.status, payload, ms


def _get(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"GET {path}: {resp.status} {payload}")
    return payload


def _b64(a: np.ndarray) -> dict:
    import base64

    return {"b64": base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii"),
            "shape": list(a.shape), "dtype": str(a.dtype)}


def _unb64(spec: dict) -> np.ndarray:
    import base64

    return np.frombuffer(base64.b64decode(spec["b64"]),
                         dtype=np.dtype(spec["dtype"])).reshape(spec["shape"])


def _serve_configs(root: str, models: dict) -> dict:
    """export_model's configs: three MIL artifacts (attention bf16, folded,
    int8 calibrated on phase 4's first train batch), the joint model (bf16)
    and the RNA MLP (float32)."""
    csv_path = os.path.join(root, "cohort.csv")
    if not os.path.isfile(csv_path):
        make_cohort(root)
    joint_csv = os.path.join(root, "joint.csv")
    if not os.path.isfile(joint_csv):
        make_joint_csv(root)
    rna_paths = make_rna_cohort(os.path.join(root, "stream", "rna"), {"train": 4}, SEED + 22)
    exports = os.path.join(root, "stream", "exports")
    mil = {"model_path": models["mil"]}
    out = {}
    for name, keys in (("mil_bf16", mil), ("mil_folded", {**mil, "fold_bn": True}),
                       ("mil_int8", {**mil, "quantize": "int8"}),
                       ("joint", {"model_path": models["joint"], "export_kind": "joint",
                                  "train_csv_path": joint_csv, "val_csv_path": joint_csv,
                                  "test_csv_path": joint_csv, "batch_size": JOINT_BATCH,
                                  "train_bag_size": 1, "val_bag_size": 1}),
                       ("rna", {"model_path": models["rna"], "export_kind": "rna",
                                "train_csv_path": rna_paths["train"]})):
        cfg, path = _config(root, csv_path, f"export_{name}",
                            export_path=os.path.join(exports, name), **keys)
        out[name] = (cfg, path)
    return out


def _serve_inputs(meta: dict, rng: np.random.Generator, b: int) -> dict:
    """A request's arrays: uint8 bags of ``SERVE_BAG`` patches (the last
    patch of the first bag padded), ones elsewhere in the mask, normal RNA
    vectors."""
    arrays = {}
    for name, dtype, dims in serve.parse_convention(meta):
        shape = [b] + [SERVE_BAG if d is None else d for d in dims[1:]]
        if name == "patch_bag":
            arrays[name] = rng.integers(0, 256, shape, dtype=np.uint8)
        elif name == "bag_mask":
            arrays[name] = np.ones(shape, np.float32)
            arrays[name][0, -1] = 0.0
        else:
            arrays[name] = rng.standard_normal(shape).astype(dtype)
    return arrays


def _eager_adapter(name: str, cfg: dict, device: torch.device):
    """The port's eager serving adapter of an exported model, built as the
    savescore / extract CLIs build it (int8: calibrated on the same first
    train batch as the export)."""
    config = Config(cfg)
    if name == "rna":
        return rna_train.rna_serving_adapter(config, device, RNA_GENES)
    if name == "joint":
        datasets = joint_train.build_joint_datasets(config, False)
        build = functools.partial(joint_train.build_joint_model, in_features=RNA_GENES)
        return serving_adapter(config, device, datasets, build, JointAdapter)
    return serving_adapter(config, device, build_datasets(config, False))


def drive_export_serve(root: str, device: torch.device, smi: str) -> tuple[dict, dict]:
    """Phase 19: ``export_model`` on the card (MIL attention bf16, folded,
    int8; joint; RNA), no kernel launched while tracing; one ``serve``
    thread on 127.0.0.1 (a free port, ``--buckets 1,8 --warmup 1``) serving
    them all; ``SERVE_REQUESTS`` b64 requests a model (batches 1-8, bags of
    16 at 224 px), counted (K1, K3, K4 through the programs' custom ops);
    each response bit for bit a direct call of the loaded program on the
    same padded input, and within ``SERVE_TOL`` of the eager model; health,
    listing, and 400s for malformed requests; latency p50 / p95 and
    requests/s a model."""
    t_phase = time.perf_counter()
    models = _stream_models(root)
    configs = _serve_configs(root, models)
    runs, e2e = {}, {"export_s": {}, "models": {}}
    for name, (cfg, path) in configs.items():
        t0 = time.perf_counter()
        runs[f"export_model_{name}"] = _run_counted(f"export_model {name}", export_model.main,
                                                    path, {}, smi)
        e2e["export_s"][name] = time.perf_counter() - t0
    argv = [arg for name, (cfg, _) in configs.items()
            for arg in ("--artifact", f"{name}={cfg['export_path']}")]
    server = serve.build_server(argv + ["--port", "0", "--buckets", SERVE_BUCKETS,
                                        "--warmup", "1", "--quiet", "1"])
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = _get(port, "/healthz")
        listing = _get(port, "/v1/models")
        if sorted(health["models"]) != sorted(configs) or sorted(listing) != sorted(configs):
            raise AssertionError(f"health {health}, listing {sorted(listing)}")
        rng = np.random.default_rng(SEED + 23)
        requests = {name: [] for name in configs}
        reset_counts()
        for name in configs:
            meta = listing[name]
            lat = []
            t0 = time.perf_counter()
            for _ in range(SERVE_REQUESTS):
                b = int(rng.integers(1, SERVE_MAX_BATCH + 1))
                arrays = _serve_inputs(meta, rng, b)
                body = {k: _b64(v) for k, v in arrays.items()}
                body["encoding"] = "b64"
                status, payload, ms = _post(port, f"/v1/models/{name}/score", body)
                if status != 200:
                    raise AssertionError(f"{name}: {status} {payload}")
                lat.append(ms)
                requests[name].append((arrays, {k: _unb64(v) for k, v in payload.items()
                                                if k != "latency_ms"}))
            total = time.perf_counter() - t0
            e2e["models"][name] = {"p50_ms": float(np.percentile(lat, 50)),
                                   "p95_ms": float(np.percentile(lat, 95)),
                                   "requests_per_s": SERVE_REQUESTS / total}
        torch.cuda.synchronize()
        counts = read_counts()
        n = SERVE_REQUESTS
        want = _expected(attention=3 * n, k3_batches=n, k4_batches=n)
        print(f"served programs: launches {counts} (expected {want}) [{smi}]")
        if counts != want:
            raise AssertionError(f"the served programs launched {counts}, expected {want}")
        runs["serve"] = {"launches": counts, "wall_s": sum(
            SERVE_REQUESTS / m["requests_per_s"] for m in e2e["models"].values())}
        for body, want_msg in (({"data": [[0.0]]}, "missing argument"),
                               ({"patch_bag": [[1, 2]], "bag_mask": [[1.0]]}, "dims")):
            status, payload, _ = _post(port, "/v1/models/mil_bf16/score", body)
            if status != 400 or want_msg not in payload.get("error", ""):
                raise AssertionError(f"malformed request: {status} {payload}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    buckets = [int(b) for b in SERVE_BUCKETS.split(",")]
    for name, (cfg, _) in configs.items():
        program = artifact.load_artifact(cfg["export_path"])
        adapter = _eager_adapter(name, cfg, device)
        meta = program.meta
        kind = ("int8" if meta["quantize"] else
                "float32" if name == "rna" else "bfloat16")
        worst, exact = 0.0, True
        for arrays, got in requests[name]:
            b = next(iter(arrays.values())).shape[0]
            pad = serve.next_bucket(b, buckets) - b
            direct = program.call(*[torch.as_tensor(np.concatenate(
                [a, np.repeat(a[-1:], pad, axis=0)])).to(device) for a in arrays.values()])
            for k, v in direct.items():
                exact &= np.array_equal(v.cpu().numpy()[:b], got[k])
            batch = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
            eager = {"embedding": adapter.extract(batch), "scores": adapter.apply(batch)}
            for k in ("embedding", "scores"):
                e = eager[k].float().cpu().numpy()
                worst = max(worst, float(np.abs(got[k] - e).max() / max(np.abs(e).max(), 1e-6)))
        e2e["models"][name].update(bit_exact_vs_program=exact, eager_rel_err=worst,
                                   tolerance=SERVE_TOL[kind])
        print(f"serve {name}: {json.dumps(e2e['models'][name])} [{smi}]")
        if not exact or worst > SERVE_TOL[kind]:
            raise AssertionError(f"serve {name}: bit for bit {exact}, eager rel err {worst}")
    e2e["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19: {e2e['seconds']:.1f} s")
    return runs, e2e


# --- phase 20: evaluation and orchestration -------------------------------------

# (b)-(d): two folds, one epoch each; the sweep's four learning rates of the
# RNA encoder under successive halving by 2 over SWEEP_EPOCHS (rungs of 1
# and 2 epochs), on a smaller cohort at the reference width
CV_FOLDS = 2
# cv_run --task rna folds the first rows of phase 6's train split (its
# host CSV work, not the card, set phase 20's time: cut from 1,280 rows in
# PR 15 to keep the smoke under 900 s with phase 21)
CV_RNA_ROWS = 384
SWEEP_LRS = [1e-3, 1e-4, 1e-5, 1e-6]
SWEEP_EPOCHS, SWEEP_SPLITS = 2, {"train": 512, "val": 128, "test": 128}
# (e) resamples of the evaluated frames; the bootstrap timed at BOOT_CASES
# seeded cases x BOOT_RESAMPLES on the card, and the host's numpy loop (the
# JAX package's) over the first HOST_BOOT_RESAMPLES of the same draws
EVAL_BOOT = 1000
BOOT_CASES, BOOT_RESAMPLES, HOST_BOOT_RESAMPLES = 2000, 1000, 100
# (f) the rnfour encoder on the card vs the CPU, float32: rtol, atol
SURGERY_TOL = (1e-3, 1e-4)
SURGERY_BATCH = 4


def _histo_splits(root: str, name: str, leak: bool = False) -> str:
    """Phase 4's cohort as three case-disjoint splits (c0-c3 train, c4 val,
    c5 test; or with ``leak``, c0's row in val too) and a histo config on
    them; returns the config's path."""
    with open(os.path.join(root, "cohort.csv")) as f:
        header, *rows = f.read().splitlines()
    split_of = {"c4": "val", "c5": "test"}
    paths = {}
    for split in ("train", "val", "test"):
        keep = [r for r in rows if split_of.get(r.split(",")[0], "train") == split]
        if leak and split == "val":
            keep.append(rows[0])
        paths[split] = os.path.join(root, f"{name}_{split}.csv")
        with open(paths[split], "w") as f:
            f.write("\n".join([header] + keep) + "\n")
    return _config(root, paths["train"], name, val_csv_path=paths["val"],
                   test_csv_path=paths["test"])[1]


def check_validate_data(root: str, smi: str) -> dict:
    """20a: ``validate_data`` on phase 4's slides in case-disjoint splits
    and on phase 6's RNA cohort (exit 0), then on the slides with a train
    case leaked into val (exit 1)."""
    rna_cfg = os.path.join(root, "rna.json")
    out = {}
    for name, argv, want in (
        ("histo", ["--config", _histo_splits(root, "validate_histo"), "--task", "histo"], 0),
        ("rna", ["--config", rna_cfg, "--task", "rna"], 0),
        ("histo_leaked", ["--config", _histo_splits(root, "validate_leak", leak=True),
                          "--task", "histo"], 1),
    ):
        t0 = time.perf_counter()
        rc = validate_data.main(argv)
        out[name] = {"rc": rc, "wall_s": time.perf_counter() - t0}
        print(f"validate_data {name}: exit {rc} (expected {want}); "
              f"{out[name]['wall_s']:.2f} s [{smi}]")
        if rc != want:
            raise AssertionError(f"validate_data {name} exited {rc}, expected {want}")
    return out


def _n_csv_rows(path: str) -> int:
    with open(path) as f:
        return sum(1 for _ in f) - 1


def _check_cv_outputs(ckpt: str, flag: str, n_cases: int, n_test: int) -> dict:
    """The fold frames, ``cv_summary.csv`` (a finite val and test C-index
    a fold), the out-of-fold frame (every case once) and the ensemble frame
    (the test split's cases) of a ``cv_run``."""
    for k in range(1, CV_FOLDS + 1):
        for split in ("val", "test"):
            found = [p for p in os.listdir(os.path.join(ckpt, "outputs", f"{flag}_cv{k}"))
                     if p.endswith(f"_{split}_{flag}_cv{k}_df.csv")]
            if len(found) != 1:
                raise AssertionError(f"fold {k}: no single {split} frame: {found}")
    summary = read_frame(os.path.join(ckpt, "cv_summary.csv"))
    if summary["fold"] != list(range(1, CV_FOLDS + 1)) or not all(
            np.isfinite(summary[c]).all() for c in ("val_CI", "test_CI")):
        raise AssertionError(f"{ckpt}: bad cv_summary {summary}")
    oof = read_frame(os.path.join(ckpt, "cv_oof_val_df.csv"))
    ens = read_frame(os.path.join(ckpt, "cv_ensemble_test_df.csv"))
    if (len(set(oof["id"])) != n_cases or n_rows(oof) != n_cases
            or not np.isfinite(oof["score"]).all()):
        raise AssertionError(f"{ckpt}: bad out-of-fold frame ({n_rows(oof)} rows)")
    if list(ens) != ["id", "score", "survival_months", "vital_status"] \
            or n_rows(ens) != n_test or not np.isfinite(ens["score"]).all():
        raise AssertionError(f"{ckpt}: bad ensemble frame {list(ens)} ({n_rows(ens)} rows)")
    return {"val_CI": summary["val_CI"], "test_CI": summary["test_CI"]}


def drive_cv_runs(root: str, smi: str) -> tuple[dict, dict]:
    """20b, 20c: ``cv_run --task rna`` on the first ``CV_RNA_ROWS`` of
    phase 6's train rows (12,778 genes, the test split fixed) and ``cv_run --task histo`` on
    phase 4's slides (ResNet-50 / attention 2048 / bf16 / 224 px, the
    cohort its own fixed test split), two folds of one epoch, counted:
    K2a and K2b a train step, K1 a train step and an eval batch, its
    backward a train step. The histo training CLI keeps a best model from its
    second epoch on under ``reference_parity``, so its one-epoch folds run
    without it, as the savescore step needs their ``model_dict_best.pt``."""
    paths = {s: os.path.join(root, "rna", f"rna_{s}.csv") for s in RNA_SPLITS}
    rna_ckpt = os.path.join(root, "cv_rna_ckpt")
    cv_rows = os.path.join(root, "cv_rna.csv")
    with open(paths["train"]) as f, open(cv_rows, "w") as out:
        out.writelines(itertools.islice(f, 1 + CV_RNA_ROWS))
    _, rna_cfg = _rna_config(root, paths, "cv_rna", num_epochs=1, flag="rna_cv",
                             checkpoint_path=rna_ckpt, cv_csv_path=cv_rows)
    csv_path = os.path.join(root, "cohort.csv")
    histo_keys = dict(_histo_train_keys(root, "cv_histo_ckpt"), flag="histo_cv")
    histo, histo_cfg = _config(root, csv_path, "cv_histo", num_epochs=1,
                               cv_csv_path=csv_path, reference_parity=False, **histo_keys)

    def fold_rows(ckpt):
        return [(_n_csv_rows(os.path.join(ckpt, "cv", f"fold{k}", "train.csv")),
                 _n_csv_rows(os.path.join(ckpt, "cv", f"fold{k}", "val.csv")))
                for k in range(1, CV_FOLDS + 1)]

    def rna_expected():
        steps = sum(math.ceil(n_train / RNA_BATCH) for n_train, _ in fold_rows(rna_ckpt))
        return {"dropout_matmul": K2A_PER_STEP * steps, "seeded_dropout": K2B_PER_STEP * steps,
                "seeded_dropout_pair": K2B_PAIR_PER_STEP * steps}

    def histo_expected():
        slides_per_batch = B * BAG // N_PATCH  # a slide's patches in bags of BAG
        k1 = bwd = 0
        for n_train, n_val in fold_rows(histo["checkpoint_path"]):
            train, val, test = (math.ceil(n / slides_per_batch) for n in (n_train, n_val, N_WSI))
            # one epoch: the steps and the train and val evals; the last and
            # the best model on the three splits; savescore on the three
            k1 += (train + train + val) + 2 * (train + val + test) + (train + val + test)
            bwd += train
        return {"attention_pool": k1, "attention_pool_backward": bwd}

    args = ["--folds", str(CV_FOLDS), "--seed", str(SEED)]
    runs = {
        "cv_run_rna": _run_counted("cv_run --task rna", cv_run.main,
                                   ["--config", rna_cfg, "--task", "rna"] + args,
                                   rna_expected, smi),
        "cv_run_histo": _run_counted("cv_run --task histo", cv_run.main,
                                     ["--config", histo_cfg, "--task", "histo"] + args,
                                     histo_expected, smi),
    }
    n_cases = len(set(read_frame(csv_path)["case"]))
    e2e = {"rna": _check_cv_outputs(rna_ckpt, "rna_cv", CV_RNA_ROWS, RNA_SPLITS["test"]),
           "histo": _check_cv_outputs(histo["checkpoint_path"], "histo_cv", n_cases, n_cases)}
    print(f"cv_run folds: {e2e} [{smi}]")
    return runs, e2e


def drive_sweep(root: str, smi: str) -> tuple[dict, dict]:
    """20d: ``sweep --task rna --halving 2`` over ``SWEEP_LRS`` (``lr_rna``)
    on a seeded cohort at the reference width, counted (K2a and K2b a train
    step: every combination's first rung, the survivors' resumed one); the
    summary ranks the two survivors (2 epochs) first, each group by val
    C-index, and every combination's train state holds the steps of the
    epochs the summary says it trained."""
    paths = make_rna_cohort(os.path.join(root, "rna_sweep"), SWEEP_SPLITS, SEED + 20)
    ckpt = os.path.join(root, "sweep_ckpt")
    _, cfg_path = _rna_config(root, paths, "sweep_rna", num_epochs=SWEEP_EPOCHS,
                              flag="rna_sweep", checkpoint_path=ckpt)
    steps_per_epoch = math.ceil(SWEEP_SPLITS["train"] / RNA_BATCH)
    # rung 1: every combination 1 epoch; rung 2: the top half 1 more
    steps = (len(SWEEP_LRS) + len(SWEEP_LRS) // 2) * steps_per_epoch
    run = _run_counted(
        "sweep --task rna --halving 2", sweep.main,
        ["--config", cfg_path, "--task", "rna", "--halving", "2", "--seed", str(SEED),
         "--grid", json.dumps({"lr_rna": SWEEP_LRS})],
        {"dropout_matmul": K2A_PER_STEP * steps, "seeded_dropout": K2B_PER_STEP * steps,
         "seeded_dropout_pair": K2B_PAIR_PER_STEP * steps}, smi)
    summary = read_frame(os.path.join(ckpt, "sweep_summary.csv"))
    epochs, ci = summary["epochs_trained"], summary["val_CI"]
    if epochs != [2, 2, 1, 1] or ci[:2] != sorted(ci[:2], reverse=True) \
            or ci[2:] != sorted(ci[2:], reverse=True):
        raise AssertionError(f"sweep ranking: epochs {epochs}, val_CI {ci}")
    for combo, n_epochs in zip(summary["combo"], epochs):
        meta = train_checkpoint.load(os.path.join(
            ckpt, "models", f"rna_sweep_hp{combo}", "train_state.pt"))["meta"]
        if meta["step"] != n_epochs * steps_per_epoch:
            raise AssertionError(f"combo {combo}: {meta['step']} steps in its state, "
                                 f"expected {n_epochs * steps_per_epoch}")
    with open(os.path.join(ckpt, "sweep_best_config.json")) as f:
        best = json.load(f)
    if best["lr_rna"] != SWEEP_LRS[summary["combo"][0] - 1]:
        raise AssertionError(f"sweep best config {best['lr_rna']} is not the top row's")
    print(f"sweep: combos {summary['combo']}, epochs {epochs}, val_CI {ci}; "
          f"best lr_rna {best['lr_rna']} [{smi}]")
    return {"sweep_rna_halving": run}, {"combo": summary["combo"], "epochs_trained": epochs,
                                        "val_CI": ci}


def _same_report(got, want, path: str = "") -> None:
    """Card and CPU reports: the C-index and its bounds bit for bit, every
    other number within 1e-12 of its size."""
    if isinstance(want, dict):
        if list(got) != list(want):
            raise AssertionError(f"{path}: keys {list(got)} != {list(want)}")
        for k in want:
            _same_report(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} != {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_report(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and path.rsplit(".", 1)[-1] in ("c_index", "ci_lower",
                                                                 "ci_upper"):
        if not (got == want or (math.isnan(got) and math.isnan(want))):
            raise AssertionError(f"{path}: card {got!r} != CPU {want!r}")
    elif isinstance(want, float):
        if not (abs(got - want) <= 1e-12 * abs(want) or (math.isnan(got) and math.isnan(want))):
            raise AssertionError(f"{path}: card {got!r} != CPU {want!r}")
    elif got != want:
        raise AssertionError(f"{path}: card {got!r} != CPU {want!r}")


def check_evaluate_scores(root: str, device: torch.device, smi: str) -> tuple[dict, dict]:
    """20e: ``evaluate_scores`` over 20b's out-of-fold and ensemble frames
    on the card (counted: no kernel of the port) and with ``--device cpu``:
    equal reports. Then the bootstrap alone at ``BOOT_CASES`` seeded cases
    x ``BOOT_RESAMPLES`` on the card (the call's wall clock, and the pair
    counting's CUDA-event time) beside the same counts on the CPU and the
    host's numpy loop (the JAX package's) over the first
    ``HOST_BOOT_RESAMPLES`` resamples: equal counts, and C-indices equal
    bit for bit."""
    ckpt = os.path.join(root, "cv_rna_ckpt")
    frames = [os.path.join(ckpt, f) for f in ("cv_oof_val_df.csv", "cv_ensemble_test_df.csv")]
    argv = ["--scores", *frames, "--n_boot", str(EVAL_BOOT)]
    card, cpu = os.path.join(root, "eval_card"), os.path.join(root, "eval_cpu")
    run = _run_counted("evaluate_scores", evaluate_scores.main,
                       argv + ["--output_dir", card], {}, smi)
    t0 = time.perf_counter()
    evaluate_scores.main(argv + ["--output_dir", cpu, "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    reports = {}
    for path in frames:
        name = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(card, f"evaluation_{name}.json")) as f:
            got = json.load(f)
        with open(os.path.join(cpu, f"evaluation_{name}.json")) as f:
            want = json.load(f)
        _same_report(got, want, name)
        reports[name] = {k: got[k] for k in ("n_cases", "c_index", "ci_lower", "ci_upper",
                                             "n_boot", "logrank_p")}
    print(f"evaluate_scores: card report == CPU report for {sorted(reports)} "
          f"({reports}); the CPU run {cpu_s:.2f} s, the card's {run['wall_s']:.2f} s [{smi}]")

    rng = np.random.default_rng(SEED)
    t = np.round(rng.exponential(30.0, BOOT_CASES) / 3.0) * 3.0 + 1.0
    e = rng.random(BOOT_CASES) > 0.4
    s = rng.normal(size=BOOT_CASES)
    bootstrap_concordance(t, s, e, n_boot=8, device=device)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    boot = bootstrap_concordance(t, s, e, n_boot=BOOT_RESAMPLES, seed=SEED, device=device)
    card_wall = time.perf_counter() - t0
    idx = resample_indices(BOOT_CASES, BOOT_RESAMPLES, SEED)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    counts = bootstrap_pair_counts(t, s, e, idx, device)
    end.record()
    torch.cuda.synchronize()
    count_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    cpu_counts = bootstrap_pair_counts(t, s, e, idx, "cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [concordance_index(t[i], -s[i], e[i]) for i in idx[:HOST_BOOT_RESAMPLES]]
    host_s = time.perf_counter() - t0
    card_c = (counts[:, 1] + 0.5 * counts[:, 2]) / counts[:, 0]
    if not (np.array_equal(counts, cpu_counts)
            and np.array_equal(card_c[:HOST_BOOT_RESAMPLES], np.asarray(host))):
        raise AssertionError("bootstrap: the card's counts differ from the CPU's or the "
                             "host loop's")
    timing = {"cases": BOOT_CASES, "resamples": BOOT_RESAMPLES, "card_wall_s": card_wall,
              "card_pair_counts_ms": count_ms, "cpu_pair_counts_s": cpu_s,
              "host_resamples": HOST_BOOT_RESAMPLES, "host_loop_s": host_s,
              "host_ms_per_resample": 1e3 * host_s / HOST_BOOT_RESAMPLES,
              "c_index": boot["c_index"], "ci": [boot["ci_lower"], boot["ci_upper"]]}
    print(f"bootstrap C-index, {BOOT_CASES} cases x {BOOT_RESAMPLES} resamples: card "
          f"{card_wall:.3f} s wall (pair counts {count_ms:.2f} ms of card time); the same "
          f"counts on the CPU (torch) {cpu_s:.3f} s; host numpy loop {host_s:.2f} s for "
          f"the first {HOST_BOOT_RESAMPLES} resamples ({timing['host_ms_per_resample']:.2f} "
          f"ms a resample); all equal bit for bit [{smi}]")
    return {"evaluate_scores": run}, {"reports": reports, "cpu_run_s": cpu_s,
                                      "bootstrap": timing}


def check_conv1_surgery(root: str, device: torch.device, smi: str) -> dict:
    """20f: ``convert_checkpoint --arch resnet --in_channels 4`` on a seeded
    ResNet-50 state (conv1: RGB kept, the 4th channel the JAX package's
    ``default_rng(0)`` draw, bit for bit), then the ``rnfour`` encoder's
    forward on the card against the CPU in float32 (``SURGERY_TOL``)."""
    rgb = os.path.join(root, "resnet50_rgb.pt")
    state = random_state_dict(RESNET_CONSTRUCTORS["resnet50"](), SEED)
    torch.save(state, rgb)
    out = os.path.join(root, "resnet50_rgbx.pt")
    convert_checkpoint.main(["--torch_path", rgb, "--arch", "resnet", "--output", out,
                             "--in_channels", "4"])
    got = torch.load(out, weights_only=True)
    w = state["conv1.weight"].numpy()
    extra = np.random.default_rng(0).normal(0.0, 0.001, size=(7, 7, 1, 64)).astype(np.float32)
    want = np.concatenate([w, extra.transpose(3, 2, 0, 1)], axis=1)
    if not (np.array_equal(got["conv1.weight"].numpy(), want)
            and np.array_equal(adapt_conv1_channels(w, 4), want)):
        raise AssertionError("conv1 surgery: the 4-channel kernel is not the expected one")
    model = rnfour("resnet50", num_classes=None)
    model.load_state_dict(got)
    x = torch.randn(SURGERY_BATCH, 4, IMG, IMG, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        cpu = model.eval().extract(x)
        card = model.to(device).extract(x.to(device)).cpu()
    err = (card - cpu).abs().max().item()
    if not torch.allclose(card, cpu, rtol=SURGERY_TOL[0], atol=SURGERY_TOL[1]):
        raise AssertionError(f"rnfour card vs CPU: max_abs_diff {err}")
    print(f"rnfour (ResNet-50, 4 channels, conv1 surgery): card vs CPU max_abs_diff {err:.3g} "
          f"over {SURGERY_BATCH} x {IMG} px, float32 [{smi}]")
    return {"max_abs_diff": err}


def drive_phase20(root: str, device: torch.device, smi: str) -> tuple[dict, dict]:
    """Phase 20 (a-f); returns its counted runs and its numbers."""
    t0 = time.perf_counter()
    e2e = {"validate_data": check_validate_data(root, smi)}
    runs, e2e["cv_run"] = drive_cv_runs(root, smi)
    sweep_runs, e2e["sweep"] = drive_sweep(root, smi)
    runs.update(sweep_runs)
    eval_runs, e2e["evaluate_scores"] = check_evaluate_scores(root, device, smi)
    runs.update(eval_runs)
    e2e["conv1_surgery"] = check_conv1_surgery(root, device, smi)
    e2e["seconds"] = time.perf_counter() - t0
    print(f"phase 20: {e2e['seconds']:.1f} s")
    return runs, e2e


# --- phase 21: data, bag and tensor parallelism on the one card --------------------

# the worlds of phase 21: P21_WORLD ranks sharing the one card over gloo (NCCL
# refuses two ranks on one device), each rank this script in a process of
# its own (``--phase21-worker``), started by ``parallel/launch.py``
P21_WORLD = 2
# the RNA runs: 12,778 genes -> 4,096 -> 2,048, float32, dropout 0.5, batches
# of 256 (128 rows a rank), 2 epochs of 2 steps; val and test a padded batch
P21_RNA_SPLITS = {"train": 512, "val": 128, "test": 128}
P21_EPOCHS = 2
# the joint run: phase 15's configuration on 32 patches a slide (2 steps of 128)
P21_JOINT_PATCHES = 32
# the histo and joint runs evaluate on the first two slides of phase 4's cohort
P21_EVAL_SLIDES = 2
# first-step gradients of a world against the same run at world 1: relative
# Frobenius error per tensor (float32: K2a's split-K and the ranks' partial
# sums in another order; bf16: products rounded to bf16 in other places)
P21_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# weights after the steps: ||(w - w0) - (w1 - w0)|| / ||w1 - w0|| per tensor;
# Adam steps an element whose gradient is rounding noise by its LR either
# way, and in bf16 many are (a wrong reduction parts the two runs' updates
# by more than the update itself)
P21_UPDATE_TOL = {"float32": 0.25, "bfloat16": 1.0}
# the first-step loss of a world against world 1 (relative)
P21_LOSS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the norm below which a gradient tensor's error counts against this share
# of the largest gradient's norm, not its own: the Cox loss is blind to a
# shift of the scores, so what only shifts them (the head's bias, the last
# encoder layer's) gets a gradient of rounding noise, of the dtype's size
P21_GRAD_FLOOR = {"float32": 1e-4, "bfloat16": 1e-2}
# the TP encoder's steps (12,778 -> 4,096 -> 2,048 over mp = 2, batch 256)
P21_TP_STEPS, P21_TP_LR = 3, 1e-4
P21_TIMEOUT_S = 600
# where phase 21 writes when it has this much room (a tmpfs: RAM, not the
# machine's disk); the phase's files peak near 20 GB
P21_TMPFS, P21_TMPFS_BYTES = "/dev/shm", 32 << 30
# the device of phase 21's ranks
P21_DEVICE = "cuda"


@contextlib.contextmanager
def _synced_statistics():
    """Train-mode BatchNorm of a world of one in the synced arithmetic
    (``SyncedBatchNorm2d.synced_forward`` over this process alone), in
    place of ``nn.BatchNorm2d``'s: the world-1 runs that phase 21's worlds
    are held against."""
    original = SyncedBatchNorm2d.forward

    def forward(self, x):
        return self.synced_forward(x, None) if self.training else original(self, x)

    SyncedBatchNorm2d.forward = forward
    try:
        yield
    finally:
        SyncedBatchNorm2d.forward = original


@contextlib.contextmanager
def _first_step(record: dict, sigterm_step: int = 0):
    """While a train CLI runs: ``record`` gets its first step's global loss
    and every parameter's gradient (on the host) as the optimizer sees
    them; with ``sigterm_step`` this process sends itself SIGTERM before
    that step (1-based)."""
    from multimodalbrainsurvival_torch.train import loop

    original, calls = loop.train_step, [0]

    def train_step(adapter, optimizer, loss_fn, arrays, settings, generator):
        calls[0] += 1
        if calls[0] == sigterm_step:
            os.kill(os.getpid(), signal.SIGTERM)
        if "grads" in record:
            return original(adapter, optimizer, loss_fn, arrays, settings, generator)
        step = optimizer.step

        def take():
            record["grads"] = {n: p.grad.detach().float().cpu().clone()
                               for n, p in adapter.model.named_parameters()
                               if p.grad is not None}
            record["weights0"] = {n: p.detach().float().cpu().clone()
                                  for n, p in adapter.model.named_parameters()
                                  if p.grad is not None}
            step()

        optimizer.step = take
        try:
            loss = original(adapter, optimizer, loss_fn, arrays, settings, generator)
        finally:
            del optimizer.step
        record["loss"] = float(loss)
        return loss

    loop.train_step = train_step
    try:
        yield record
    finally:
        loop.train_step = original


P21_CLIS = {"rna_train": rna_train, "histo_train": histo_train, "joint_train": joint_train,
            "histo_extractfeatures": histo_extractfeatures,
            "slide_extractfeatures": slide_extractfeatures, "cv_run": cv_run}
# 21f: the int8 slide stream's tiles (two batches of STREAM_BATCH), and the
# int8 features' per-case cosine to world 1 (INT8_COSINE's contract is to
# the float path; the world's ranks quantize with rank 0's qtree, so only
# the float32 stem's other batch size can move a requantized value)
P21_STREAM_PATCHES = 256
P21_INT8_COSINE = 0.999
# the cv_run world's frames against world 1, |diff| / max|score|: each fold
# trains one Adam step from the same weights and dropout masks, and Adam's
# first step moves every element whose gradient is rounding noise by the
# whole LR in a direction the rounding picks (3e-4 on the CPU at small
# shapes);
# a fold scored by another model, or trained on other rows, parts by O(1)
P21_FRAME_TOL = 1e-2


def _p21_cli(job: dict, rank: int) -> dict:
    """A CLI job of a phase-21 rank: counted from 0, its first step
    captured (rank 0 saves it to ``job["grads"]``)."""
    for src, dst in job.get("copy", []):
        if rank == 0:
            shutil.copytree(src, dst)
        torch.distributed.barrier()
    record: dict = {}
    sigterm = job.get("sigterm_step", 0) if rank == job.get("sigterm_rank", -1) else 0
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _first_step(record, sigterm):
        try:
            P21_CLIS[job["cli"]].main(job["argv"])
            code = 0
        except SystemExit as e:
            code = int(e.code or 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rank == 0 and job.get("grads") and "grads" in record:
        torch.save(record, job["grads"])
    return {"name": job["name"], "code": code, "launches": read_counts(), "wall_s": wall}


def _rel(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """||got - want|| / max(||want||, floor) (0 where both are 0)."""
    num = (got.double() - want.double()).norm().item()
    den = max(want.double().norm().item(), floor)
    return num / den if den else num


def _grad_rel(got: dict, want: dict, dtype: str) -> tuple[float, str]:
    """The largest ``_rel`` over the tensors of ``want`` and its tensor's
    name, each against at least ``P21_GRAD_FLOOR`` of the largest
    gradient's norm."""
    floor = P21_GRAD_FLOOR[dtype] * max(v.double().norm().item() for v in want.values())
    return max((_rel(got[k], v, floor), k) for k, v in want.items())


def _p21_tp(job: dict, rank: int) -> dict:
    """The RNA encoder at the reference width (12,778 -> 4,096 -> 2,048,
    dropout 0.5, ``job["dtype"]``) sharded over ``mp = P21_WORLD`` by
    ``parallel/sharding.py``: ``P21_TP_STEPS`` Cox steps (Adam) timed, its
    first gradients (gathered) and the steps' update of the whole parameter
    vector (relative distance) against the unsharded encoder at world 1,
    which rank 0 runs after the sharded steps on the same batch; the time
    the steps spend in collectives recorded."""
    from multimodalbrainsurvival_torch.models import RNAEncoder, RNAOnlyModel
    from multimodalbrainsurvival_torch.ops.cox import cox_partial_likelihood_loss
    from multimodalbrainsurvival_torch.parallel import mesh as parallel
    from multimodalbrainsurvival_torch.parallel.sharding import (
        gathered_state_dict,
        joint_param_shardings,
        shard_model,
    )

    device = torch.device(P21_DEVICE)
    dtype = getattr(torch, job["dtype"])
    mesh = parallel.make_mesh(1, P21_WORLD, device=device)
    torch.manual_seed(SEED + 21)
    model = RNAOnlyModel(RNAEncoder(RNA_GENES, (4096, 2048), dropout=RNA_DROPOUT,
                                    dtype=dtype)).to(device)
    reference = copy.deepcopy(model).cpu() if rank == 0 else None
    w0 = ({k: v.float().clone() for k, v in reference.state_dict().items()}
          if rank == 0 else None)
    plan = joint_param_shardings(model)
    g = torch.Generator(device="cpu").manual_seed(SEED + 22)
    x = torch.randn(RNA_BATCH, RNA_GENES, generator=g).to(device)
    t = (torch.rand(RNA_BATCH, generator=g) * 100 + 1).to(device)
    e = (torch.rand(RNA_BATCH, generator=g) < 0.6).float().to(device)
    shard_model(model, mesh)
    collective_s = [0.0]
    timed = {name: getattr(parallel, name) for name in ("all_reduce", "all_gather")}

    def timer(fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            collective_s[0] += time.perf_counter() - t0
            return out
        return wrapped

    def steps(m, sharded):
        optimizer = torch.optim.Adam(m.parameters(), lr=P21_TP_LR)
        first, times, in_collectives = None, [], []
        for i in range(P21_TP_STEPS):
            before = collective_s[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimizer.zero_grad(set_to_none=True)
            m.train()
            with parallel.activate(parallel.BatchPut(mesh) if sharded else None):
                out = m.final_mlp(m.rna_mlp(x, seed=1000 + i))
                loss = cox_partial_likelihood_loss(out[:, 0], t, e)
                loss.backward()
            if first is None:
                grads = {n: p.grad for n, p in m.named_parameters()}
                if sharded:
                    grads = {n: parallel.all_gather(v, mesh.mp_group, plan[n])
                             if plan[n] is not None else v for n, v in grads.items()}
                first = (float(loss), {n: v.float().cpu().clone() for n, v in grads.items()})
            optimizer.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            in_collectives.append(collective_s[0] - before)
        return first, times, in_collectives

    for name, fn in timed.items():
        setattr(parallel, name, timer(fn))
    try:
        sharded_first, tp_times, tp_collective_s = steps(model, True)
    finally:
        for name, fn in timed.items():
            setattr(parallel, name, fn)
    state = {k: v.float().cpu() for k, v in gathered_state_dict(model).items()}
    rec = {"name": job["name"], "code": 0, "dtype": job["dtype"],
           "tp_step_s": tp_times, "collective_s": tp_collective_s}
    if rank == 0:
        model.cpu()
        reference.to(device)
        want_first, ref_times, _ = steps(reference, False)
        rec["world1_step_s"] = ref_times
        rec["loss_rel"] = abs(sharded_first[0] - want_first[0]) / max(abs(want_first[0]), 1e-6)
        rec["grad_rel"], rec["grad_rel_at"] = _grad_rel(sharded_first[1], want_first[1],
                                                        job["dtype"])
        ref_state = {k: v.float().cpu() for k, v in reference.state_dict().items()}
        got_update = {k: state[k] - w0[k] for k in ref_state}
        want_update = {k: v - w0[k] for k, v in ref_state.items()}
        # the whole parameter vector's update, judged; the largest tensor's,
        # recorded: the last layer's bias gets a gradient of rounding noise
        # (the Cox loss is blind to a shift of the scores), which Adam turns
        # into steps of its LR in directions the rounding picks
        rec["update_rel"] = _rel(torch.cat([v.flatten() for v in got_update.values()]),
                                 torch.cat([v.flatten() for v in want_update.values()]))
        rec["update_rel_max"], rec["update_rel_max_at"] = _grad_rel(
            got_update, want_update, job["dtype"])
        rec["ok"] = (rec["loss_rel"] <= P21_LOSS_TOL[job["dtype"]]
                     and rec["grad_rel"] <= P21_GRAD_TOL[job["dtype"]]
                     and rec["update_rel"] <= P21_UPDATE_TOL[job["dtype"]])
    torch.distributed.barrier()
    return rec


def phase21_worker(jobs_path: str, out_dir: str) -> int:
    """A rank of phase 21's world: the jobs of ``jobs_path`` in order, each
    one's record (exit status, launches per kernel, seconds) written to
    ``out_dir/rank<r>.json`` as it ends. The dry run, which closes the
    process group, comes last."""
    from multimodalbrainsurvival_torch.parallel import dryrun
    from multimodalbrainsurvival_torch.parallel import mesh as parallel

    configure_precision()
    build.build()
    parallel.initialize_from_env(torch.device(P21_DEVICE))
    rank = torch.distributed.get_rank()
    with open(jobs_path) as f:
        jobs = json.load(f)
    records = []
    for job in jobs:
        if job["kind"] == "cli":
            rec = _p21_cli(job, rank)
        elif job["kind"] == "tp":
            reset_counts()
            t0 = time.perf_counter()
            rec = _p21_tp(job, rank)
            rec.update(launches=read_counts(), wall_s=time.perf_counter() - t0)
        else:
            reset_counts()
            t0 = time.perf_counter()
            dryrun.worker(P21_DEVICE, job["dir"])
            torch.cuda.synchronize()
            rec = {"name": job["name"], "code": 0, "launches": read_counts(),
                   "wall_s": time.perf_counter() - t0}
        print(f"phase 21 rank {rank}: {json.dumps(rec)}", flush=True)
        records.append(rec)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(records, f)
    return 0


def phase21_nccl() -> int:
    """A world of one over NCCL through the port's collective helpers: each
    collective the parallel path uses, called once over the world group,
    its result checked."""
    import torch.distributed as dist

    from multimodalbrainsurvival_torch.parallel import mesh as parallel

    device = torch.device("cuda")
    backend = parallel.initialize_from_env(device)
    if backend != "nccl":
        raise AssertionError(f"a world of one on a card chose {backend}, not nccl")
    world = dist.group.WORLD
    x = torch.arange(6.0, device=device).reshape(2, 3).requires_grad_()
    checks = {
        "all_reduce": torch.equal(parallel.all_reduce(x.detach().clone(), world), x.detach()),
        "all_gather": torch.equal(parallel.all_gather(x.detach(), world, 1), x.detach()),
        "any_rank": parallel.all_reduce(torch.ones(1, device=device), world,
                                        dist.ReduceOp.MAX).item() == 1.0,
    }
    for name, fn in (("gather", lambda t: parallel.gather(t, world, 0)),
                     ("sum_partials", lambda t: parallel.sum_partials(t, world)),
                     ("reduce_from", lambda t: parallel.reduce_from(t, world)),
                     ("copy_to", lambda t: parallel.copy_to(t, world))):
        x.grad = None
        fn(x).sum().backward()
        checks[name] = torch.equal(x.grad, torch.ones_like(x))
    box = [{"flag": "rank 0"}]
    dist.broadcast_object_list(box, src=0, group=world, device=device)
    checks["broadcast_object"] = box[0] == {"flag": "rank 0"}
    dist.barrier()
    print(f"phase 21 nccl: backend {backend}, checks {json.dumps(checks)}", flush=True)
    dist.destroy_process_group()
    return 0 if all(checks.values()) else 1


def check_k2_offsets(device: torch.device, smi: str) -> dict:
    """21a: K2a (float32 and bf16) and K2b (single and paired, both dtypes)
    at the RNA shapes with nonzero ``(row0, col0)`` against their plain
    versions (K2a within ``K2A_TOL`` / ``K2A_BF16_TOL`` of the scale, K2b
    bit for bit); a TP emulation in this process (dense_0 split by output
    rows, dense_1 by input columns with ``col0``: the concatenation or the
    sum against the unsharded call) and a dp emulation (row halves with
    ``row0`` against the rows of the whole call); each form timed beside
    the offset-free call, as phase 3 times (L2 scrubbed, behind the sleep
    kernel), in turns."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 21)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    seed, p = 20240609, RNA_DROPOUT
    half = RNA_BATCH // 2
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        x = torch.randn(RNA_BATCH, RNA_GENES, generator=g).to(device, dtype)
        w0 = (torch.randn(4096, RNA_GENES, generator=g) / math.sqrt(RNA_GENES)).to(
            device, dtype)
        h = torch.randn(RNA_BATCH, 4096, generator=g).to(device, dtype)
        w1 = (torch.randn(2048, 4096, generator=g) / math.sqrt(4096)).to(device, dtype)

        def k2a_err(got, want):
            scale = want.abs().max().item()
            tol = K2A_TOL if dtype == torch.float32 else K2A_BF16_TOL * scale
            err = (got - want).abs().max().item()
            return err, tol

        checks = {}
        # the offset forms against their plain versions: a dp rank's rows of
        # dense_0 (row0 = 128), a TP rank's hidden columns of dense_1 (col0)
        xr = x[half:].contiguous()
        hc = h[:, 2048:].contiguous()
        w1c = w1[:, 2048:].contiguous()
        for label, a, b, w, r0, c0 in (("dense_0 rows 128-255", xr, None, w0, half, 0),
                                       ("dense_1 cols 2048-4095", hc, None, w1c, 0, 2048)):
            checks[f"k2a {label}"] = k2a_err(dropout_matmul(a, w, seed, p, r0, c0),
                                             dropout_matmul_plain(a, w, seed, p, r0, c0))
            single = seeded_dropout(a, seed, p, r0, c0)
            pair = seeded_dropout_pair(a, 2 * a, seed, p, r0, c0)
            want = seeded_dropout_plain(a, seed, p, r0, c0)
            checks[f"k2b {label}"] = (int((single != want).sum()), 0)
            checks[f"k2b pair {label}"] = (
                int((pair[0] != want).sum())
                + int((pair[1] != seeded_dropout_plain(2 * a, seed, p, r0, c0)).sum()), 0)
        # dp emulation: row halves at row0 against the whole call's rows
        whole0 = dropout_matmul(x, w0, seed, p)
        checks["dp k2a dense_0"] = k2a_err(torch.cat(
            [dropout_matmul(x[r * half:(r + 1) * half].contiguous(), w0, seed, p, r * half)
             for r in range(2)]), whole0)
        checks["dp k2b dense_0"] = (int((torch.cat(
            [seeded_dropout(x[r * half:(r + 1) * half].contiguous(), seed, p, r * half)
             for r in range(2)]) != seeded_dropout(x, seed, p)).sum()), 0)
        # TP emulation: dense_0's output rows, dense_1's input columns
        checks["tp k2a dense_0 (column-parallel)"] = k2a_err(torch.cat(
            [dropout_matmul(x, w0[m * 2048:(m + 1) * 2048].contiguous(), seed, p)
             for m in range(2)], 1), whole0)
        checks["tp k2a dense_1 (row-parallel)"] = k2a_err(sum(
            dropout_matmul(h[:, m * 2048:(m + 1) * 2048].contiguous(),
                           w1[:, m * 2048:(m + 1) * 2048].contiguous(), seed, p, 0, m * 2048)
            for m in range(2)), dropout_matmul(h, w1, seed, p))
        checks["tp k2b dense_1 pair"] = (sum(int((torch.cat(
            [seeded_dropout_pair(h[:, m * 2048:(m + 1) * 2048].contiguous(),
                                 h[:, m * 2048:(m + 1) * 2048].contiguous(), seed, p, 0,
                                 m * 2048)[i] for m in range(2)], 1)
            != seeded_dropout(h, seed, p)).sum()) for i in range(2)), 0)
        torch.cuda.synchronize()
        bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
        print(f"K2 offsets {dn}: {json.dumps({k: v[0] for k, v in checks.items()})} [{smi}]")
        if bad:
            raise AssertionError(f"K2 offset forms ({dn}) disagree: {bad}")
        fns = {
            "k2a": lambda: dropout_matmul(xr, w0, seed, p),
            "k2a_offset": lambda: dropout_matmul(xr, w0, seed, p, half, 0),
            "k2a_offset_plain": lambda: dropout_matmul_plain(xr, w0, seed, p, half, 0),
            # yardstick only: the port never calls it
            "k2a_offset_library": lambda: torch.matmul(xm, w0.t()),
            "k2b": lambda: seeded_dropout_pair(hc, hc, seed, p),
            "k2b_offset": lambda: seeded_dropout_pair(hc, hc, seed, p, 0, 2048),
            "k2b_offset_plain": lambda: seeded_dropout_pair_plain(hc, hc, seed, p, 0, 2048),
            "k2b_offset_library": lambda: (torch.mul(hc, mask), torch.mul(hc, mask)),
        }
        mask = (keep_mask(RNA_BATCH, 2048, seed, p, device, 0, 2048).float()
                * float(keep_scale(p))).to(dtype)
        xm = seeded_dropout_plain(xr, seed, p, half, 0)
        times = {name: [] for name in fns}
        for kind in ("k2a", "k2b"):
            for suffix in ("", "_offset", "_offset_plain", "_offset_library",
                           "_offset_library", "_offset_plain", "_offset", ""):
                times[kind + suffix].append(_time_ms(fns[kind + suffix], 25, scrub))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        size = x.element_size()
        # K2b's pair at dense_1's TP shard: two inputs read, two outputs written
        b_bytes = 4 * size * RNA_BATCH * 2048 / HBM_BYTES_PER_S * 1e3
        b_ops = 2 * RNA_BATCH * 2048 / PEAK_FLOPS[torch.float32] * 1e3
        recs[f"dropout_matmul_offset_{dn}"] = {
            "where": "dense_0, a dp rank's 128 rows at row0 = 128", "dtype": dn,
            "max_abs_err": checks["k2a dense_0 rows 128-255"][0],
            "ms": ms["k2a_offset"], "offset_free_ms": ms["k2a"],
            "plain_ms": ms["k2a_offset_plain"], "library_ms": ms["k2a_offset_library"],
            **_k2_bounds(half, RNA_GENES, 4096, dtype)}
        recs[f"seeded_dropout_pair_offset_{dn}"] = {
            "where": "dense_1's backward pair, a TP rank's 2,048 columns at col0 = 2048",
            "dtype": dn, "max_abs_err": 0.0, "ms": ms["k2b_offset"],
            "offset_free_ms": ms["k2b"], "plain_ms": ms["k2b_offset_plain"],
            "library_ms": ms["k2b_offset_library"], "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
        for name in (f"dropout_matmul_offset_{dn}", f"seeded_dropout_pair_offset_{dn}"):
            print(f"{name} {json.dumps(recs[name])} [{smi}]")
        del x, w0, h, w1, xr, hc, w1c, whole0, mask, xm
    return recs


def _p21_histo_csv(root: str) -> str:
    """Phase 4's cohort restricted to its first ``P21_EVAL_SLIDES`` slides
    (the phase-21 runs' val and test splits)."""
    with open(os.path.join(root, "cohort.csv")) as f:
        lines = f.read().splitlines()
    path = os.path.join(root, "p21_eval.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines[:1 + P21_EVAL_SLIDES]) + "\n")
    return path


def _distances(got: dict, want: dict, names, dtype: str) -> dict:
    """First-step gradients and the steps' updates of ``got`` against
    ``want`` over the tensors ``names``: the largest ``_grad_rel`` of each
    and where."""
    w0 = want["weights0"]
    grad, grad_at = _grad_rel({k: got["grads"][k] for k in names},
                              {k: want["grads"][k] for k in names}, dtype)
    update, update_at = _grad_rel({k: got["final"][k] - w0[k] for k in names},
                                  {k: want["final"][k] - w0[k] for k in names}, dtype)
    return {"grad_rel_max": grad, "grad_rel_max_at": grad_at,
            "update_rel_max": update, "update_rel_max_at": update_at}


def _p21_compare(name: str, got: dict, want: dict, dtype: str, failures: list,
                 witness: dict | None = None) -> dict:
    """A world's first step and its weights after the steps against the
    world-1 run's; a disagreement goes to ``failures``. With a ``witness``
    (the world-1 run with ``nn.BatchNorm2d``'s statistics), each group of
    tensors (the ResNet's; the rest: aggregator, heads, RNA encoder) is
    held to twice the witness's distance from the world-1 run where that
    is larger than the fixed tolerance: a train-mode ResNet-50's first
    bf16 step moves its ResNet gradients by about their whole norm, and
    the others by ~10%, when only the order of BatchNorm's sums changes,
    so no fixed tolerance tells a wrong reduction from it (a gradient
    summed over the ranks twice, or not at all, parts the heads by 50-100%
    too)."""
    loss_rel = abs(got["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-6)
    names = list(want["grads"])
    groups = {"rest": names}
    if witness is not None:
        groups = {"resnet": [k for k in names if k.startswith("resnet.")],
                  "rest": [k for k in names if not k.startswith("resnet.")]}
    rec = {"loss": got["loss"], "world1_loss": want["loss"], "loss_rel": loss_rel}
    ok = loss_rel <= P21_LOSS_TOL[dtype]
    for group, keys in groups.items():
        if not keys:
            continue
        rec[group] = _distances(got, want, keys, dtype)
        allowed = {"grad_rel_max": P21_GRAD_TOL[dtype],
                   "update_rel_max": P21_UPDATE_TOL[dtype]}
        if witness is not None:
            rec[f"{group}_witness"] = _distances(witness, want, keys, dtype)
            allowed = {k: max(v, 2 * rec[f"{group}_witness"][k]) for k, v in allowed.items()}
        ok = ok and all(rec[group][k] <= v for k, v in allowed.items())
    if not (want["loss"] and any(v.abs().max().item() for v in want["grads"].values())):
        failures.append(f"{name}: the first step's loss or gradients are 0 at world 1 (a "
                        "batch without an event): nothing to compare")
    print(f"phase 21 {name} ({dtype}) vs world 1: {json.dumps(rec)}")
    if not ok:
        failures.append(f"{name} disagrees with its world-1 run: {rec}")
    return rec


def _final_weights(cfg: dict, flag: str, names) -> dict:
    state = torch.load(os.path.join(cfg["checkpoint_path"], "models", flag, "model_last.pt"),
                       weights_only=True)
    return {k: state[k].float() for k in names}


def _p21_mesh_paths(root: str, work: str, rna_paths: dict, histo_cfg, extract_cfg
                    ) -> dict:
    """21f's runs: name -> (cli, (config, argv) at world 2, at world 1,
    kind). The world-1 runs are the same configurations without the mesh."""
    dp2 = {"dp": P21_WORLD}
    f32_held = {"compute_dtype": "float32", "freeze_bn": True}
    d = os.path.join(root, "stream")
    slide = os.path.join(d, "wsi", "slide.png")
    if not os.path.isfile(slide):  # phase 21 run alone
        os.makedirs(os.path.dirname(slide), exist_ok=True)
        write_stream_slide(slide)
    _stream_models(root)

    def slide_cfg(name, **kw):
        cfg, path = _stream_config(root, name, quantize="int8",
                                   max_patches_per_slide=P21_STREAM_PATCHES,
                                   save_patch_features=False,
                                   output_path=os.path.join(work, name), **kw)
        return cfg, ["--config", path]

    cv_rows = os.path.join(work, "cv_rna.csv")
    with open(rna_paths["train"]) as f, open(cv_rows, "w") as out:
        out.writelines(itertools.islice(f, 1 + CV_RNA_ROWS))

    def cv_cfg(name, **kw):
        cfg, path = _rna_config(work, rna_paths, name, num_epochs=1, flag="rna_cv",
                                cv_csv_path=cv_rows, **kw)
        return cfg, ["--config", path, "--task", "rna", "--folds", str(CV_FOLDS),
                     "--seed", str(SEED)]

    def argv(c):
        return c[0], ["--config", c[1]]

    return {
        "extract_int8_dp2": ("histo_extractfeatures",
                             argv(extract_cfg("extract_int8_dp2", quantize="int8", mesh=dp2)),
                             argv(extract_cfg("extract_int8_w1", quantize="int8")), "int8"),
        "extract_folded_dp2": ("histo_extractfeatures",
                               argv(extract_cfg("extract_folded_dp2", fold_bn=True, mesh=dp2)),
                               argv(extract_cfg("extract_folded_w1", fold_bn=True)), "folded"),
        "histo_train_trunk_dp2": ("histo_train",
                                  argv(histo_cfg("histo_trunk_dp2", quantize_trunk="int8",
                                                 mesh=dp2, **f32_held)),
                                  argv(histo_cfg("histo_trunk_w1", quantize_trunk="int8",
                                                 **f32_held)), "train"),
        # its world-1 run reads the host loader: the cache's batches are its
        "histo_train_cache_dp2": ("histo_train",
                                  argv(histo_cfg("histo_cache_dp2", mesh=dp2,
                                                 cache_patches_on_device=True, **f32_held)),
                                  argv(histo_cfg("histo_cache_w1", **f32_held)), "train"),
        "slide_extractfeatures_int8_dp2": ("slide_extractfeatures",
                                           slide_cfg("p21_slide_int8_dp2", mesh=dp2),
                                           slide_cfg("p21_slide_int8_w1"), "slide"),
        "cv_run_rna_dp2": ("cv_run", cv_cfg("p21_cv_rna_dp2", mesh=dp2),
                           cv_cfg("p21_cv_rna_w1"), "cv"),
    }


def _kernel_launches(launches: dict) -> dict:
    """A run's launches of K1, K3 (its conv forms, which ``qmm_requant``
    counts with the residual one, and the stem pass), K4 and K2 (K2a, K2b
    single and paired, both dtypes)."""
    return {"K1": launches["attention_pool"],
            "K3": launches["qmm_requant"] + launches["stem_requant_pool"],
            "K4": launches["fused_bottleneck_stage"],
            "K2": sum(launches[k] for k in ("dropout_matmul", "seeded_dropout",
                                             "seeded_dropout_pair"))}


def _p21_check_mesh_paths(mesh_runs: dict, world1: dict, records: list, failures: list,
                          smi: str) -> tuple[dict, dict]:
    """21f's checks: each rank's launches against the world-1 run's (the
    slide tail, K1, on rank 0 alone: it alone scores and writes), and the
    outputs against world 1's: the extract features (int8: per-case cosine
    ``P21_INT8_COSINE``; folded bf16: ``SERVE_TOL``), the train runs' first
    step and weights (float32, BatchNorm held: the whole gradient vector
    and the whole update against ``P21_GRAD_TOL`` / ``P21_UPDATE_TOL``), the slide
    frames, and the folds' frames (``P21_FRAME_TOL``) with one set of fold
    files."""
    by_cli, checks, table = {}, {}, {}
    for name, (cli, (cfg, _), (cfg1, _), kind) in mesh_runs.items():
        want = world1[name]
        table[name] = {"world1": _kernel_launches(want["launches"])}
        for rank in range(P21_WORLD):
            rec = records[rank][name]
            expected = dict(want["launches"])
            if kind == "slide" and rank:
                expected["attention_pool"] = 0
            table[name][f"rank{rank}"] = _kernel_launches(rec["launches"])
            if rec["code"] != 0 or rec["launches"] != expected:
                failures.append(f"{name} rank {rank}: exit {rec['code']}, launches "
                                f"{rec['launches']} (expected {expected})")
            by_cli[f"{name}_rank{rank}"] = {"launches": rec["launches"],
                                            "wall_s": rec["wall_s"]}
        if not any(table[name]["world1"].values()):
            failures.append(f"{name}: no kernel of its path launched")
        if kind in ("int8", "folded"):
            diffs = {}
            for split in ("train", "val", "test"):
                a, b = (np.loadtxt(os.path.join(c["output_path"],
                                                f"pathology_features_{split}.csv"),
                                   delimiter=",", ndmin=2) for c in (cfg, cfg1))
                if kind == "int8":
                    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
                    diffs[split] = {"cosine_min": float(cos.min()),
                                    "max_abs_diff": float(np.abs(a - b).max())}
                    ok = a.shape == b.shape and cos.min() >= P21_INT8_COSINE
                else:
                    diffs[split] = {"max_abs_diff": float(np.abs(a - b).max())}
                    ok = a.shape == b.shape and diffs[split]["max_abs_diff"] <= \
                        SERVE_TOL["bfloat16"] * max(1.0, float(np.abs(b).max()))
                if not (ok and np.isfinite(a).all()):
                    failures.append(f"{name} {split}: features differ from world 1: "
                                    f"{diffs[split]}")
            checks[name] = diffs
        elif kind == "train":
            # BatchNorm held (freeze_bn), float32: the first step's whole
            # gradient vector and the steps' whole update are world 1's up to
            # the sums' order; a tensor's own can part further (the Cox-blind
            # head bias's gradient is rounding noise: 3.4e-3 of its own norm
            # on an H100), recorded, not judged. A gradient
            # summed over the ranks twice, or not at all, parts the whole
            # vector by half of it
            got, ref = torch.load(want["world_grads"]), want["record"]
            names = list(ref["grads"])
            got["final"] = _final_weights(cfg, cfg["flag"], names)
            ref["final"] = _final_weights(cfg1, cfg1["flag"], names)

            def whole(r, key, base=None):
                return torch.cat([(r[key][k] - (0 if base is None else base[k])).flatten()
                                  for k in names])

            rec = {"loss_rel": abs(got["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-6),
                   "grad_rel": _rel(whole(got, "grads"), whole(ref, "grads")),
                   "update_rel": _rel(whole(got, "final", ref["weights0"]),
                                      whole(ref, "final", ref["weights0"])),
                   **_distances(got, ref, names, "float32")}
            checks[name] = rec
            if not (rec["loss_rel"] <= P21_LOSS_TOL["float32"]
                    and rec["grad_rel"] <= P21_GRAD_TOL["float32"]
                    and rec["update_rel"] <= P21_UPDATE_TOL["float32"]):
                failures.append(f"{name} disagrees with its world-1 run: {rec}")
        elif kind == "slide":
            a, b = (read_frame(os.path.join(c["output_path"], "slide_scores.csv"))
                    for c in (cfg, cfg1))
            fa, fb = (np.loadtxt(os.path.join(c["output_path"],
                                              "pathology_features_slides.csv"),
                                 delimiter=",", ndmin=2) for c in (cfg, cfg1))
            cos = float((fa * fb).sum() / np.linalg.norm(fa) / np.linalg.norm(fb))
            checks[name] = {"n_patches": a["n_patches"], "score": a["score"],
                            "world1_score": b["score"], "embedding_cosine": cos}
            if a["n_patches"] != b["n_patches"] or cos < P21_INT8_COSINE \
                    or not np.isfinite(fa).all():
                failures.append(f"{name}: slide frames differ from world 1: {checks[name]}")
        else:  # cv
            ckpt, ckpt1 = cfg["checkpoint_path"], cfg1["checkpoint_path"]
            rel = 0.0
            for k in range(1, CV_FOLDS + 1):
                for split in ("val", "test"):
                    frame = f"outputs/rna_cv_cv{k}/rna_{split}_rna_cv_cv{k}_df.csv"
                    a, b = (np.array(_read_csv_column(os.path.join(c, frame), "score"), float)
                            for c in (ckpt, ckpt1))
                    if a.shape != b.shape or not np.isfinite(a).all():
                        failures.append(f"{name}: {frame} has {a.shape} scores "
                                        f"(world 1: {b.shape})")
                        continue
                    rel = max(rel, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)))
                for split in ("train", "val"):
                    fold_csv = f"cv/fold{k}/{split}.csv"
                    with open(os.path.join(ckpt, fold_csv), "rb") as fa, \
                            open(os.path.join(ckpt1, fold_csv), "rb") as fb:
                        if fa.read() != fb.read():
                            failures.append(f"{name}: {fold_csv} differs from world 1's")
            runs_written = sorted(os.listdir(os.path.join(ckpt, "models")))
            checks[name] = {"frames_rel_max": rel, "runs_written": runs_written}
            if rel > P21_FRAME_TOL or runs_written != [f"rna_cv_cv{k}"
                                                       for k in range(1, CV_FOLDS + 1)]:
                failures.append(f"{name}: frames {rel} from world 1, runs {runs_written}")
        print(f"phase 21f {name}: {json.dumps(checks[name], default=str)} [{smi}]")
    print(f"phase 21f launches a rank (K1 / K3 / K4 / K2) beside world 1: "
          f"{json.dumps(table)} [{smi}]")
    checks["launches"] = table
    return by_cli, checks


def drive_phase21(root: str, device: torch.device, smi: str) -> tuple[dict, dict]:
    """Phase 21 (``_drive_phase21``) with its outputs in a directory on
    ``P21_TMPFS`` when that has room: the phase writes ~20 GB of
    checkpoints, many rewritten epoch by epoch, and the card's machine caps
    the bytes written to its disk (deleted ones count), which the smoke
    reached with them on disk. Removed at the phase's end."""
    fits = os.path.isdir(P21_TMPFS) and shutil.disk_usage(P21_TMPFS).free > P21_TMPFS_BYTES
    scratch = tempfile.mkdtemp(dir=P21_TMPFS) if fits else None
    print(f"phase 21 writes under {scratch or root}"
          + ("" if fits else f" ({P21_TMPFS} has no {P21_TMPFS_BYTES >> 30} GiB free)"))
    try:
        return _drive_phase21(root, os.path.join(scratch or root, "p21"), device, smi)
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)


def _drive_phase21(root: str, work: str, device: torch.device, smi: str
                   ) -> tuple[dict, dict]:
    """Phase 21, its outputs under ``work``: (a) K2's offset forms on the card; (b) worlds of
    ``P21_WORLD`` ranks sharing the card over gloo (``rna_train``,
    ``histo_train`` under ``{"dp": 2}`` and ``{"dp": 1, "mp": 2,
    "shard_bag": true}`` in bf16 and float32, ``joint_train``,
    ``histo_extractfeatures``, the TP
    RNA encoder in float32 and bf16, the dry run), each counted per rank and
    held against the same run at world 1, which this process runs while
    the world works; (c) a world of one over NCCL; (d) ``rna_train``
    preempted on rank 1 alone and resumed at world 2 and at world 1; (e)
    the TP step's time at world 2 and 1 with its collectives' share; (f)
    a second world, beside the first, on the paths of ``_p21_mesh_paths``
    (``_p21_check_mesh_paths``)."""
    t_phase = time.perf_counter()
    e2e = {"k2_offsets": check_k2_offsets(device, smi)}
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(work)
    paths = make_rna_cohort(os.path.join(work, "rna"), P21_RNA_SPLITS, SEED + 21)
    histo_csv = os.path.join(root, "cohort.csv")
    eval_csv = _p21_histo_csv(root)
    joint_csv = os.path.join(root, "joint.csv")
    dp2, bag = {"dp": P21_WORLD}, {"dp": 1, "mp": P21_WORLD, "shard_bag": True}

    def rna_cfg(name, **kw):
        return _rna_config(work, paths, name, num_epochs=P21_EPOCHS, **kw)

    patches = os.path.join(root, "patches")

    def histo_cfg(name, **kw):
        return _config(work, histo_csv, name, num_epochs=1, val_csv_path=eval_csv,
                       test_csv_path=eval_csv, model_path="", data_path=patches,
                       **_histo_train_keys(work, f"{name}_ckpt"), **kw)

    def joint_cfg(name, **kw):
        eval_joint = os.path.join(work, "p21_joint_eval.csv")
        if not os.path.exists(eval_joint):
            with open(joint_csv) as f:
                head = [next(f) for _ in range(1 + P21_EVAL_SLIDES)]
            with open(eval_joint, "w") as f:
                f.writelines(head)
        return _joint_config(work, joint_csv, name, num_epochs=1,
                             max_patch_per_wsi_train=P21_JOINT_PATCHES,
                             max_patch_per_wsi_val=P21_JOINT_PATCHES,
                             val_csv_path=eval_joint, test_csv_path=eval_joint,
                             data_path=patches, **kw)

    def extract_cfg(name, **kw):
        return _config(work, histo_csv, name, val_csv_path=eval_csv, test_csv_path=eval_csv,
                       model_path=os.path.join(root, "model.pt"), data_path=patches,
                       output_path=os.path.join(work, name), **kw)

    f32 = {"compute_dtype": "float32"}
    # name -> (cli, config and path at world 2, at world 1, dtype)
    runs = {
        "rna_train_dp2": ("rna_train", rna_cfg("rna_dp2", mesh=dp2), rna_cfg("rna_w1"),
                          "float32"),
        "histo_train_dp2": ("histo_train", histo_cfg("histo_dp2", mesh=dp2),
                            histo_cfg("histo_w1"), "bfloat16"),
        "histo_train_bag": ("histo_train", histo_cfg("histo_bag", mesh=bag), None,
                            "bfloat16"),
        # float32, where the ResNet's first step is reproducible under
        # rounding (a ~1% witness): what holds the patch encoder's reduction
        "histo_train_dp2_f32": ("histo_train", histo_cfg("histo_dp2_f32", mesh=dp2, **f32),
                                histo_cfg("histo_w1_f32", **f32), "float32"),
        "histo_train_bag_f32": ("histo_train", histo_cfg("histo_bag_f32", mesh=bag, **f32),
                                None, "float32"),
        "joint_train_dp2": ("joint_train", joint_cfg("joint_dp2", mesh=dp2),
                            joint_cfg("joint_w1"), "bfloat16"),
        "histo_extractfeatures_dp2": ("histo_extractfeatures",
                                      extract_cfg("extract_dp2", mesh=dp2),
                                      extract_cfg("extract_w1"), "bfloat16"),
    }
    preempt, preempt_path = rna_cfg("rna_preempt", mesh=dp2, preempt_sync_every=1)
    resume2, resume2_path = rna_cfg("rna_resume2", mesh=dp2, resume=True)
    resume1, resume1_path = rna_cfg("rna_resume1", resume=True)
    jobs = [{"kind": "cli", "name": name, "cli": cli, "argv": ["--config", c[1]],
             "grads": os.path.join(work, f"{name}.grads.pt")}
            for name, (cli, c, _, _) in runs.items()]
    jobs += [
        {"kind": "cli", "name": "rna_train_preempted", "cli": "rna_train",
         "argv": ["--config", preempt_path], "sigterm_rank": 1, "sigterm_step": 2},
        {"kind": "cli", "name": "rna_train_resumed_dp2", "cli": "rna_train",
         "argv": ["--config", resume2_path],
         "copy": [(preempt["checkpoint_path"], resume2["checkpoint_path"]),
                  (preempt["checkpoint_path"], resume1["checkpoint_path"])]},
        {"kind": "tp", "name": "tp_rna_float32", "dtype": "float32"},
        {"kind": "tp", "name": "tp_rna_bfloat16", "dtype": "bfloat16"},
        {"kind": "dryrun", "name": "dryrun_multichip", "dir": os.path.join(work, "dryrun")},
    ]
    os.makedirs(os.path.join(work, "dryrun"))
    mesh_runs = _p21_mesh_paths(root, work, paths, histo_cfg, extract_cfg)
    jobs_b = [{"kind": "cli", "name": name, "cli": cli, "argv": c[1],
               "grads": os.path.join(work, f"{name}.grads.pt")}
              for name, (cli, c, _, _) in mesh_runs.items()]
    t_world = time.perf_counter()
    worlds = {}
    for tag, world_jobs, env in (("", jobs, None),
                                 ("_b", jobs_b, {**os.environ, "OMP_NUM_THREADS": "2"})):
        jobs_path = os.path.join(work, f"jobs{tag}.json")
        with open(jobs_path, "w") as f:
            json.dump(world_jobs, f)
        out = os.path.join(work, f"records{tag}")
        os.makedirs(out)
        worlds[tag] = (out, launch.start(
            P21_WORLD, [sys.executable, os.path.join(here, "chip_smoke.py"),
                        "--phase21-worker", jobs_path, out],
            os.path.join(work, f"logs{tag}"), env=env, cwd=here))
    out_dir, ranks = worlds[""]
    out_dir_b, ranks_b = worlds["_b"]
    # the world-1 runs, in this process, while the world works, with
    # train-mode BatchNorm in the synced arithmetic over this process alone
    # (nn.BatchNorm2d's own sums part ResNet-50's first-step gradients from
    # it by far more than the ranks' summation order does: recorded below).
    # A bag-sharded run's world-1 run is its dp run's: the mesh changes no
    # result
    same_run = {"histo_train_bag": "histo_train_dp2",
                "histo_train_bag_f32": "histo_train_dp2_f32"}
    world1 = {}
    try:
        for name, (cli, _, c1, _) in runs.items():
            if c1 is None:
                continue
            record: dict = {}
            reset_counts()
            t0 = time.perf_counter()
            with _first_step(record), _synced_statistics():
                P21_CLIS[cli].main(["--config", c1[1]])
            torch.cuda.synchronize()
            world1[name] = {"launches": read_counts(), "record": record, "cfg": c1[0],
                            "wall_s": time.perf_counter() - t0}
            print(f"phase 21 {name} at world 1: launches {world1[name]['launches']}, "
                  f"{world1[name]['wall_s']:.2f} s")
        # the witnesses: the histo and joint runs with nn.BatchNorm2d's
        # statistics
        witness = {}
        for name, (cli, cfg1, path1) in (
                ("histo_train_dp2", ("histo_train", *histo_cfg("histo_w1_native"))),
                ("histo_train_dp2_f32", ("histo_train",
                                         *histo_cfg("histo_w1_native_f32", **f32))),
                ("joint_train_dp2", ("joint_train", *joint_cfg("joint_w1_native")))):
            witness[name] = {}
            with _first_step(witness[name]):
                P21_CLIS[cli].main(["--config", path1])
            witness[name]["final"] = _final_weights(cfg1, cfg1["flag"],
                                                    witness[name]["grads"])
        # 21f's world-1 runs
        world1_b = {}
        for name, (cli, _, (cfg1, argv1), _) in mesh_runs.items():
            record: dict = {}
            reset_counts()
            t0 = time.perf_counter()
            with _first_step(record):
                P21_CLIS[cli].main(argv1)
            torch.cuda.synchronize()
            world1_b[name] = {"launches": read_counts(), "record": record,
                              "wall_s": time.perf_counter() - t0,
                              "world_grads": os.path.join(work, f"{name}.grads.pt")}
            print(f"phase 21f {name} at world 1: launches {world1_b[name]['launches']}, "
                  f"{world1_b[name]['wall_s']:.2f} s")
    finally:
        codes = launch.wait(ranks, P21_TIMEOUT_S)
        codes_b = launch.wait(ranks_b, P21_TIMEOUT_S)
    world_s = time.perf_counter() - t_world
    logs = [r.output() for r in ranks]
    for tag, world_codes, world_ranks in (("", codes, ranks), ("f", codes_b, ranks_b)):
        for rank, (code, r) in enumerate(zip(world_codes, world_ranks)):
            log = r.output()
            print(f"--- phase 21{tag} rank {rank} (exit {code}), its last lines:\n"
                  + "\n".join(log.splitlines()[-12:]))
            if code:
                raise AssertionError(f"phase 21{tag} rank {rank} exited {code}:\n"
                                     f"{log[-6000:]}")
    records, records_b = [], []
    for rank in range(P21_WORLD):
        for d, recs in ((out_dir, records), (out_dir_b, records_b)):
            with open(os.path.join(d, f"rank{rank}.json")) as f:
                recs.append({r["name"]: r for r in json.load(f)})
    for name, same in same_run.items():
        world1[name], witness[name] = world1[same], witness[same]

    # (b) each world run: counted on every rank as at world 1, first step and
    # weights against world 1, frames present and finite. Every check runs;
    # the phase fails at its end if any did
    by_cli, checks, failures = {}, {}, []
    for name, (cli, (cfg, _), _, dtype) in runs.items():
        want = world1[name]
        for rank in range(P21_WORLD):
            rec = records[rank][name]
            print(f"phase 21 {name} rank {rank}: exit {rec['code']}, launches "
                  f"{rec['launches']}, {rec['wall_s']:.2f} s")
            if rec["code"] != 0 or rec["launches"] != want["launches"]:
                failures.append(f"{name} rank {rank}: exit {rec['code']}, launches "
                                f"{rec['launches']} (world 1: {want['launches']})")
            by_cli[f"{name}_rank{rank}"] = {"launches": rec["launches"],
                                            "wall_s": rec["wall_s"]}
        if not any(want["launches"][k] for k in ("attention_pool", "dropout_matmul")):
            failures.append(f"{name}: no kernel of its path launched")
        if cli == "histo_extractfeatures":
            diffs = {}
            for split in ("train", "val", "test"):
                a = np.loadtxt(os.path.join(cfg["output_path"],
                                            f"pathology_features_{split}.csv"), delimiter=",")
                b = np.loadtxt(os.path.join(want["cfg"]["output_path"],
                                            f"pathology_features_{split}.csv"), delimiter=",")
                diffs[split] = float(np.abs(a - b).max())
                if a.shape != b.shape or not np.isfinite(a).all() or \
                        diffs[split] > SERVE_TOL["bfloat16"] * max(1.0, np.abs(b).max()):
                    failures.append(f"{name} {split}: features differ from world 1 by "
                                    f"{diffs[split]}")
            checks[name] = {"features_max_abs_diff": diffs}
            print(f"phase 21 {name}: frames vs world 1 max_abs_diff {diffs} [{smi}]")
            continue
        got = torch.load(os.path.join(work, f"{name}.grads.pt"))
        flag = cfg["flag"]
        got["final"] = _final_weights(cfg, flag, want["record"]["grads"])
        want["record"]["final"] = _final_weights(want["cfg"], flag, want["record"]["grads"])
        checks[name] = _p21_compare(name, got, want["record"], dtype, failures,
                                    witness.get(name))
        outputs = os.path.join(cfg["checkpoint_path"], "outputs", flag)
        for split in ("train", "val", "test"):
            for tag in ("last", "best"):
                path = os.path.join(outputs, f"{split}_output_{tag}.csv")
                scores = np.array(_read_csv_column(path, "score"), float)
                if not (scores.size and np.isfinite(scores).all()):
                    failures.append(f"{path}: bad scores {scores}")

    mesh_by_cli, checks["mesh_paths"] = _p21_check_mesh_paths(mesh_runs, world1_b,
                                                              records_b, failures, smi)
    by_cli.update(mesh_by_cli)

    # (d) preemption of rank 1 alone: both ranks exit 143 and leave one
    # .preempt; resumed at world 2 the run ends with the uninterrupted run's
    # weights; resumed at world 1 it finishes
    pre = [records[r]["rna_train_preempted"]["code"] for r in range(P21_WORLD)]
    res = [records[r]["rna_train_resumed_dp2"]["code"] for r in range(P21_WORLD)]
    saved = os.listdir(os.path.join(preempt["checkpoint_path"], "models", "rna_smoke"))
    if pre != [PREEMPTED_EXIT_CODE] * P21_WORLD or saved != ["train_state.pt.preempt"] \
            or res != [0] * P21_WORLD:
        failures.append(f"preemption: exits {pre}, files {saved}, resumed exits {res}")
    uninterrupted = _final_weights(runs["rna_train_dp2"][1][0], "rna_smoke",
                                   world1["rna_train_dp2"]["record"]["grads"])
    resumed = _final_weights(resume2, "rna_smoke", uninterrupted)
    differ = sum(int((resumed[k] != v).sum()) for k, v in uninterrupted.items())
    if differ:
        failures.append(f"the run resumed at world 2 differs from the uninterrupted run "
                        f"in {differ} weights")
    rna_train.main(["--config", resume1_path])
    _final_weights(resume1, "rna_smoke", uninterrupted)
    checks["preemption"] = {"exits": pre, "resumed_world2_exits": res,
                            "resumed_world2_weights_differing": differ,
                            "resumed_world1": "finished"}
    print(f"phase 21 preemption: SIGTERM to rank 1 alone -> exits {pre}, files {saved}; "
          f"resumed at world 2: exits {res}, {differ} weights differ from the "
          f"uninterrupted run's; resumed at world 1: finished [{smi}]")

    # the TP encoder (checked on rank 0 in the world) and the dry run
    for name in ("tp_rna_float32", "tp_rna_bfloat16", "dryrun_multichip"):
        by_cli[name] = {"launches": records[0][name].get("launches"),
                        "wall_s": records[0][name].get("wall_s")}
    tp = {}
    for dtype in ("float32", "bfloat16"):
        r0 = records[0][f"tp_rna_{dtype}"]
        tp[dtype] = {k: r0[k] for k in ("loss_rel", "grad_rel", "grad_rel_at", "update_rel",
                                         "update_rel_max", "update_rel_max_at", "tp_step_s",
                                         "world1_step_s", "collective_s")}
        print(f"phase 21 TP RNA encoder ({dtype}) vs world 1: {json.dumps(tp[dtype])}")
        if not r0["ok"]:
            failures.append(f"TP RNA encoder ({dtype}) vs world 1: {tp[dtype]}")
        # the steps after the first (its kernels' first launches)
        step = float(np.median(r0["tp_step_s"][1:]))
        coll = float(np.median(r0["collective_s"][1:]))
        tp[dtype]["collective_share"] = coll / step
        print(f"phase 21 TP RNA encoder ({dtype}, mp = {P21_WORLD} on one card over gloo): "
              f"step {step * 1e3:.1f} ms at world 2 vs "
              f"{float(np.median(r0['world1_step_s'][1:])) * 1e3:.1f} ms at world 1, "
              f"collectives {coll * 1e3:.1f} ms a step "
              f"({tp[dtype]['collective_share']:.1%}; through the host, not NVLink) "
              f"[{smi}]")
    checks["tp_rna"] = tp
    checks["dryrun"] = next((line for line in logs[0].splitlines()
                             if "dryrun_multichip OK" in line), None)
    if checks["dryrun"] is None:
        failures.append("the dry run printed no OK line")

    # (c) NCCL: a world of one through the same collective helpers
    nccl = launch.run(1, [sys.executable, os.path.join(here, "chip_smoke.py"),
                          "--phase21-nccl"], os.path.join(work, "nccl"), 300, cwd=here)
    checks["nccl"] = next((line for line in nccl[0][1].splitlines()
                           if "phase 21 nccl" in line), None)
    if nccl[0][0] != 0 or "backend nccl" not in nccl[0][1]:
        failures.append(f"the NCCL world of one failed:\n{nccl[0][1][-3000:]}")
    if torch.cuda.device_count() < 2:
        checks["nccl_dp2"] = "not run: one card (NCCL refuses two ranks on one device)"
    print(checks["nccl"])
    if failures:
        raise AssertionError("phase 21 failed:\n" + "\n".join(failures))
    e2e.update(checks)
    e2e["world_s"] = world_s
    e2e["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21: {e2e['seconds']:.1f} s (the world {world_s:.1f} s)")
    return by_cli, e2e


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    # the ranks of phase 21's worlds (the script starts them itself)
    if argv[:1] == ["--phase21-worker"]:
        return phase21_worker(argv[1], argv[2])
    if argv[:1] == ["--phase21-nccl"]:
        return phase21_nccl()
    device = torch.device("cuda")
    configure_precision()
    smi = _nvidia_smi()
    t_start = time.perf_counter()

    def stamp(done: str) -> None:  # where the run's time goes, phase by phase
        print(f"[{time.perf_counter() - t_start:.1f} s] {done} done", flush=True)

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
    k2f = check_dropout_matmul_fusion(device, smi)
    k4 = check_fused_stage(device)
    stamp("build and kernel checks")

    with tempfile.TemporaryDirectory() as root:
        launches, e2e = drive_main_path(root, device, smi)
        stamp("drive_main_path")
        check_against_cpu(root, os.path.join(root, "cohort.csv"))
        stamp("check_against_cpu")
        rna_launches, rna_e2e = drive_rna_path(root, device, smi,
                                               k2["dropout_matmul"]["ms"])
        stamp("drive_rna_path")
        check_rna_against_cpu(root)
        stamp("check_rna_against_cpu")
        train_launches, train_e2e = drive_histo_train_path(root, device, smi, k1_ms)
        stamp("drive_histo_train_path")
        check_histo_train_against_cpu(root)
        stamp("check_histo_train_against_cpu")
        task_launches, task_e2e = drive_histo_tasks(root, device, smi, k1_ms)
        stamp("drive_histo_tasks")
        references = {name: check_histo_train_against_cpu(root, name, **TASKS[name])
                      for name in ("classification", "survival_bin")}
        stamp("the tasks' CPU references")
        references["transformer_serving"] = check_transformer_against_cpu(root)
        stamp("check_transformer_against_cpu")
        preemption = check_preemption(root, smi)
        stamp("check_preemption")
        rna_int8 = drive_rna_int8(root, device, smi, k2)
        stamp("drive_rna_int8")
        early_launches, early_e2e = drive_early_fusion(root, device, smi, k2f)
        stamp("drive_early_fusion")
        joint_launches, joint_e2e = drive_joint_path(root, device, smi, k2f)
        stamp("drive_joint_path")
        fusion_references = check_fusion_against_cpu(root)
        stamp("check_fusion_against_cpu")
        p17_runs, p17 = drive_phase17(root, device, smi, k1_ms)
        stamp("drive_phase17")
        stream_runs, stream = drive_streaming(root, device, smi)
        stamp("drive_streaming")
        serve_runs, served = drive_export_serve(root, device, smi)
        stamp("drive_export_serve")
        p20_runs, p20 = drive_phase20(root, device, smi)
        stamp("drive_phase20")
        p21_runs, p21 = drive_phase21(root, device, smi)
        stamp("drive_phase21")
    e2e.update(rna_e2e)
    e2e.update(train_e2e)
    e2e.update(task_e2e)
    e2e["task_references_max_abs_diff"] = references
    e2e["preemption"] = preemption
    e2e.update(early_e2e)
    e2e.update(joint_e2e)
    e2e.update({k: v for k, v in rna_int8.items() if k != "launches"})
    e2e["fusion_references_max_abs_diff"] = fusion_references
    e2e["phase17"] = p17
    e2e["phase18_streaming"] = stream
    e2e["phase19_serving"] = served
    e2e["phase20"] = p20
    e2e["phase21"] = {k: v for k, v in p21.items() if k != "k2_offsets"}
    train_launches.update(task_launches)
    fusion_runs = {**rna_int8["launches"], **early_launches, **joint_launches, **p17_runs,
                   **stream_runs, **serve_runs, **p20_runs, **p21_runs}
    train_launches.update(fusion_runs)
    for cli, rec in train_launches.items():
        launches[cli] = rec["launches"]
    k2_runs = {**rna_launches, **fusion_runs}
    k2_names = ("dropout_matmul", "seeded_dropout", "seeded_dropout_pair")
    # each K2 counter counts both dtypes: its float32 form's launches are the
    # rest after the bf16 form's
    k2_launches = {name: {cli: rec["launches"][name] - rec["launches"].get(f"{name}_bf16", 0)
                          for cli, rec in k2_runs.items()} for name in k2_names}
    k2_bf16 = {name: {cli: rec["launches"][f"{name}_bf16"] for cli, rec in k2_runs.items()
                      if rec["launches"][f"{name}_bf16"]} for name in k2_names}
    k2_source = "multimodalbrainsurvival_torch/kernels/csrc/dropout_matmul.cu"
    # deleted from the JAX package; read it with git show 4fbc57a^:<file>
    k2_replaces = "multimodalbrainsurvival_tpu/ops/pallas/dropout_matmul.py:"
    k2b_pair = {"name": "seeded_dropout_pair", "route": "cuda", "source": k2_source,
                "replaces": k2_replaces + "135",
                "launches": sum(k2_launches["seeded_dropout_pair"].values()),
                "launches_by_path": {cli: n for cli, n in
                                     k2_launches["seeded_dropout_pair"].items() if n},
                **k2["seeded_dropout_pair"], "tolerance": 0}
    k2b_pair_bf16 = {"name": "seeded_dropout_pair_bf16", "route": "cuda",
                     "source": k2_source, "replaces": k2_replaces + "135",
                     "launches": sum(k2_bf16["seeded_dropout_pair"].values()),
                     "launches_by_path": k2_bf16["seeded_dropout_pair"],
                     **k2f["seeded_dropout_pair_bf16"], "tolerance": 0}

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
        "launches_by_path": {cli: n for cli, n in k2_launches["dropout_matmul"].items()
                             if n},
        # times and bounds: sums over the shapes listed (drop probability 0.5)
        **k2["dropout_matmul"],
        "tolerance": K2A_TOL,
        # float32 at the early-fusion MLP's and the joint head's shapes
        "fusion_shapes": k2f["dropout_matmul_fusion_f32"],
    }, {
        "name": "dropout_matmul_bf16",
        "route": "cuda",
        "source": k2_source,
        "replaces": k2_replaces + "160",
        "launches": sum(k2_bf16["dropout_matmul"].values()),
        "launches_by_path": k2_bf16["dropout_matmul"],
        # times and bounds: sums over the joint RNA encoder's two layers at
        # batch 128 (drop probability 0.5); library: torch.matmul of the
        # pre-masked bf16 x
        **k2f["dropout_matmul_bf16"],
        "tolerance": "%g of max|plain|" % K2A_BF16_TOL,
    }, {
        "name": "seeded_dropout_bf16",
        "route": "cuda",
        "source": k2_source,
        "replaces": k2_replaces + "135",
        "launches": k2b_pair_bf16["launches"] + sum(k2_bf16["seeded_dropout"].values()),
        "launches_by_path": {cli: k2_bf16["seeded_dropout"].get(cli, 0)
                             + k2b_pair_bf16["launches_by_path"].get(cli, 0)
                             for cli in {*k2_bf16["seeded_dropout"],
                                         *k2b_pair_bf16["launches_by_path"]}},
        **k2f["seeded_dropout_bf16"],
        "tolerance": 0,
        "pair": k2b_pair_bf16,
    }, {
        "name": "seeded_dropout",
        "route": "cuda",
        "source": k2_source,
        "replaces": k2_replaces + "135",
        # K2b in both forms: the single form's launches and the pair's
        "launches": k2b_pair["launches"] + sum(k2_launches["seeded_dropout"].values()),
        "launches_by_path": {cli: n + k2_launches["seeded_dropout_pair"][cli]
                             for cli, n in k2_launches["seeded_dropout"].items()
                             if n + k2_launches["seeded_dropout_pair"][cli]},
        # the single form's times and bounds: sums over the shapes listed
        # (drop probability 0.5)
        **k2["seeded_dropout"],
        "tolerance": 0,
        # the paired form at dense_1's shape: two tensors, one launch
        "pair": k2b_pair,
    }] + [{
        # K2's forms at a rank's offset in the global mask (phase 21a): the
        # launches are those of phase 21's worlds, every rank's
        "name": name,
        "route": "cuda",
        "source": k2_source,
        "replaces": k2_replaces + ("160" if name.startswith("dropout_matmul") else "135"),
        "launches": sum(rec["launches"][counter] - rec["launches"].get(f"{counter}_bf16", 0)
                        for cli, rec in p21_runs.items()),
        **rec21,
        "tolerance": (0 if name.startswith("seeded") else K2A_TOL if "float32" in name
                      else "%g of max|plain|" % K2A_BF16_TOL),
    } for name, rec21 in p21["k2_offsets"].items()
        for counter in [{"dropout_matmul_offset_float32": "dropout_matmul",
                         "dropout_matmul_offset_bfloat16": "dropout_matmul_bf16",
                         "seeded_dropout_pair_offset_float32": "seeded_dropout_pair",
                         "seeded_dropout_pair_offset_bfloat16": "seeded_dropout_pair_bf16"
                         }[name]]] + [{
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
    }, {
        # K1 at the streaming slide tail's shape: one bag of up to 2,048
        # patches, one launch a slide (phase 18)
        "name": "attention_pool_slide_tail",
        "route": "cuda",
        "source": "multimodalbrainsurvival_torch/kernels/csrc/attention_pool.cu",
        "replaces": "multimodalbrainsurvival_tpu/ops/pallas/tanh_attention.py:111",
        "launches": sum(rec["launches"]["attention_pool"] for cli, rec in stream_runs.items()
                        if cli.startswith("slide_extractfeatures")),
        "launches_by_path": {cli: rec["launches"]["attention_pool"]
                             for cli, rec in stream_runs.items()
                             if cli.startswith("slide_extractfeatures")},
        **{key: stream["slide_tail_k1"][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dtype")},
        "tolerance": KERNEL_TOL,
    }], "rna_cli_wall_s": {cli: rec["wall_s"] for cli, rec in rna_launches.items()},
        "histo_train_cli_wall_s": {cli: rec["wall_s"] for cli, rec in train_launches.items()},
        **e2e}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
