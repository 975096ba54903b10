"""Fused folded-BN bottleneck stage (K4): CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``fused_bottleneck_stage`` / ``_stage_kernel``
(``multimodalbrainsurvival_tpu/ops/pallas/fused_stage.py``, retired in
commit ``183b10c``; ``pallas_call`` at ``:150``, the block at
``_block_step`` ``:40``): a chain of stride-1 bottleneck blocks of a
``fold_bn`` ResNet, each ``relu(x·w1 + b1)`` → 3×3 ``relu(· + b2)`` →
``· w3 + b3``, plus the residual (``x·wd + bd`` on a projection block, else
``x``), then ReLU. The kernel source is ``csrc/fused_stage.cu``; its header
says what bounds it on the card and what its design does about that. It
launches once per block: y1 and y2 stay in shared memory, the residual
stream between blocks goes through device memory.

Cast points are the retired ``_block_step``'s: float32 sums, float32 bias
and ReLU, rounded to the compute dtype after each of y1 and y2; z and the
residual are each rounded, added in the compute dtype, then ReLU.

Layouts: ``x`` is an NCHW tensor in ``channels_last`` memory (NHWC), as the
port's encoder makes it, float32 or bfloat16; the output is the same. On
the card bfloat16 runs ``wgmma`` fed by TMA (``Cm`` ≤ 128: layer1 and
layer2 of the ResNet family), float32 plain FMA.
``pack_bottleneck`` puts a folded ``Bottleneck``'s weights into the
kernel's layout: each (N, K) with K contiguous, the 3×3's K in (dy, dx, c)
order (the TPU kernel's ``(3, 3, Cm, Cm) → (9·Cm, Cm)`` reshape), in the
compute dtype; biases float32. Channel counts are multiples of 8.

``fused_bottleneck_stage`` dispatches on the device of its input: a CPU
tensor goes to ``fused_bottleneck_stage_plain``; a CUDA tensor launches the
kernel once per block or raises. ``fused_bottleneck_stage.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from multimodalbrainsurvival_torch.kernels.qmm_requant import im2col

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


class PackedBlock(NamedTuple):
    """One folded bottleneck block in the kernel's layout."""

    w1: torch.Tensor  # (Cm, Cin)
    b1: torch.Tensor  # (Cm,) float32
    w2: torch.Tensor  # (Cm, 9·Cm), K in (dy, dx, c) order
    b2: torch.Tensor  # (Cm,)
    w3: torch.Tensor  # (Cout, Cm)
    b3: torch.Tensor  # (Cout,)
    wd: torch.Tensor | None  # (Cout, Cin); None: identity residual
    bd: torch.Tensor | None  # (Cout,)


def _packed_weight(conv, dtype) -> torch.Tensor:
    """(N, C, kh, kw) conv weight → (N, kh·kw·C), K in (dy, dx, c) order."""
    w = conv.weight.detach().permute(0, 2, 3, 1)
    return w.reshape(conv.out_channels, -1).to(dtype).contiguous()


def pack_bottleneck(block, dtype: torch.dtype) -> PackedBlock:
    """A stride-1 ``fold_bn=True`` ``Bottleneck`` (``models/resnet.py``) →
    its weights in the kernel's layout and ``dtype``, on its device."""
    if block.conv2.stride != (1, 1):
        raise ValueError("the fused stage takes stride-1 blocks only")
    down = block.downsample[0] if block.downsample is not None else None
    convs = [c for c in (block.conv1, block.conv2, block.conv3, down) if c is not None]
    if any(c.bias is None for c in convs):
        raise ValueError("the fused stage takes folded blocks (convolutions with a bias)")
    w1, w2, w3 = (_packed_weight(c, dtype) for c in convs[:3])
    b1, b2, b3 = (c.bias.detach().float().contiguous() for c in convs[:3])
    if down is None:
        return PackedBlock(w1, b1, w2, b2, w3, b3, None, None)
    return PackedBlock(w1, b1, w2, b2, w3, b3, _packed_weight(down, dtype),
                       down.bias.detach().float().contiguous())


def _check(x, blocks: Sequence[PackedBlock]) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be a 4-d float32 or bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be NCHW in channels_last memory (NHWC)")
    if not blocks:
        raise ValueError("the stage needs at least one block")
    channels = x.shape[1]
    for i, blk in enumerate(blocks):
        cm, cin = blk.w1.shape
        cout = blk.w3.shape[0]
        shapes = {"w1": (cm, channels), "b1": (cm,), "w2": (cm, 9 * cm), "b2": (cm,),
                  "w3": (cout, cm), "b3": (cout,)}
        if blk.wd is not None:
            shapes.update(wd=(cout, cin), bd=(cout,))
        elif cin != cout:
            raise ValueError(f"block {i}: an identity residual needs Cin == Cout, "
                             f"got {cin} and {cout}")
        for name, shape in shapes.items():
            t = getattr(blk, name)
            want = torch.float32 if name[0] == "b" else x.dtype
            if tuple(t.shape) != shape or t.dtype != want or t.device != x.device:
                raise ValueError(f"block {i}: {name} must be {shape} {want} on "
                                 f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"block {i}: {name} must be contiguous")
        if (cin % 8) or (cm % 8) or (cout % 8):
            raise ValueError(f"block {i}: channel counts must be multiples of 8, "
                             f"got {cin}, {cm}, {cout}")
        channels = cout


def fused_block_plain(x: torch.Tensor, blk: PackedBlock) -> torch.Tensor:
    """One block on NHWC ``x`` (B, H, W, Cin) → (B, H, W, Cout) in x's
    dtype: float32 products of the rounded operands, cast as the kernel
    casts. Autocast is off inside, so that the products stay float32."""
    B, H, W, cin = x.shape
    dt = x.dtype
    with torch.autocast(x.device.type, enabled=False):
        x2 = x.reshape(-1, cin)
        x32 = x2.float()
        y1 = (x32 @ blk.w1.float().t() + blk.b1).relu().to(dt)
        # the 3×3's zero padding is y1's: pad, then (dy, dx, c) columns
        cols = im2col(y1.reshape(B, H, W, -1), 3, 3, 1, 1)
        y2 = (cols.float() @ blk.w2.float().t() + blk.b2).relu().to(dt)
        z = (y2.float() @ blk.w3.float().t() + blk.b3).to(dt)
        r = x2 if blk.wd is None else (x32 @ blk.wd.float().t() + blk.bd).to(dt)
        return (z + r).relu().reshape(B, H, W, -1)


def fused_bottleneck_stage_plain(x: torch.Tensor, blocks: Sequence[PackedBlock]
                                 ) -> torch.Tensor:
    """The stage in plain PyTorch: ``fused_block_plain`` block by block."""
    _check(x, blocks)
    y = x.permute(0, 2, 3, 1)
    for blk in blocks:
        y = fused_block_plain(y, blk)
    return y.permute(0, 3, 1, 2)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multimodalbrainsurvival_torch.kernels import build

        lib = build.load("fused_stage")
        lib.fused_bottleneck_block.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        lib.fused_bottleneck_block.restype = ctypes.c_int
        lib.fused_bottleneck_plan.argtypes = (
            [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)])
        lib.fused_bottleneck_plan.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_block_plan(dtype: torch.dtype, H: int, W: int, cin: int, cm: int,
                     cout: int, projection: bool) -> dict:
    """The tile the kernel takes for one block of this shape (read from the
    built library): rows and columns of output pixels, output channels per
    pass of the last product, shared memory bytes, tiles per image."""
    plan = (ctypes.c_int * 5)()
    err = _library().fused_bottleneck_plan(_DTYPE_CODES[dtype], H, W, cin, cm,
                                           cout, int(projection), plan)
    if err != 0:
        raise ValueError(f"the kernel takes no block of shape {H}x{W}, "
                         f"{cin} -> {cm} -> {cout}")
    return dict(zip(("tile_h", "tile_w", "nb", "smem_bytes", "tiles"), plan))


def fused_bottleneck_stage(x: torch.Tensor, blocks: Sequence[PackedBlock]
                           ) -> torch.Tensor:
    """A chain of stride-1 folded bottleneck blocks (``pack_bottleneck``)
    on ``x`` (B, Cin, H, W) in ``channels_last`` memory → (B, Cout, H, W),
    the same layout and dtype."""
    if x.device.type == "cpu":
        return fused_bottleneck_stage_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_stage runs on cpu or cuda, not {x.device}")
    _check(x, blocks)
    if x.data_ptr() % 16 or any(t.data_ptr() % 16 for b in blocks
                                for t in (b.w1, b.w2, b.w3, b.wd) if t is not None):
        raise ValueError("the kernel takes a 16-byte aligned x and weights")
    B, _, H, W = x.shape
    if x.numel() >= 2**31 or B * H * W * max(b.w3.shape[0] for b in blocks) >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} is beyond the kernel's range")
    lib = _library()
    y = x.permute(0, 2, 3, 1)  # the NHWC view of the same memory
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for blk in blocks:
            (cm, cin), cout = blk.w1.shape, blk.w3.shape[0]
            out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
            err = lib.fused_bottleneck_block(
                _DTYPE_CODES[x.dtype], y.data_ptr(), out.data_ptr(),
                blk.w1.data_ptr(), blk.b1.data_ptr(), blk.w2.data_ptr(),
                blk.b2.data_ptr(), blk.w3.data_ptr(), blk.b3.data_ptr(),
                None if blk.wd is None else blk.wd.data_ptr(),
                None if blk.bd is None else blk.bd.data_ptr(),
                B, H, W, cin, cm, cout, stream,
            )
            if err != 0:
                raise RuntimeError(f"fused_bottleneck_stage kernel launch failed: "
                                   f"CUDA error {err}")
            fused_bottleneck_stage.launches += 1
            y = out
    return y.permute(0, 3, 1, 2)


fused_bottleneck_stage.launches = 0
