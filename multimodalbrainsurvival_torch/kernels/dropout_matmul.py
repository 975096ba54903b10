"""Seeded dropout fused into a matrix product (K2a) and applied alone (K2b):
CUDA kernel wrappers, plain versions and the autograd function.

Replaces the TPU kernels of ``multimodalbrainsurvival_tpu/ops/pallas/
dropout_matmul.py`` (deleted in commit ``4fbc57a``): ``_forward`` /
``_dropout_matmul_kernel`` (``pallas_call`` at ``:160``) and
``apply_seeded_dropout`` / ``_apply_dropout_kernel`` (``:135``), with the
``custom_vjp`` ``_bwd`` (``:207-218``) as ``DropoutMatmul``. The kernel
source is ``csrc/dropout_matmul.cu`` (K2a's product is ``csrc/splitk_tn.cuh``:
3xTF32 on the tensor cores, K split over a cluster, loads by TMA or by
``cp.async`` as the rows' alignment allows); its header says what bounds it
on the card and what its design does about that.

The keep-mask is a counter hash of ``(seed, row, col)``, a copy of the TPU
kernel's ``_mask_block`` (``:52-71``) in ``uint32``: ``gidx = row·65536 +
col``, ``h = gidx ^ (seed·0x9E3779B1)``, a murmur3 finalizer, keep iff
``h >= min(int(p·2³²), 2³²−1)``; a kept value is ``x·float32(1/(1−p))``.
Every function takes ``row0, col0`` (default 0), the tensor's offset in a
larger mask: it hashes ``(row0 + row, col0 + col)``. A data-parallel rank
that holds rows ``[row0, row0 + M)`` of a batch, or a tensor-parallel rank
that holds hidden columns ``[col0, col0 + K)`` (``parallel/sharding.py``),
so draws the part of the mask that the unsharded call draws there; ``col0 +
K`` may not pass ``MAX_K``. So the backward regenerates the mask instead of
storing it::

    y  = (M⊙x)·s @ Wᵀ
    dx = M⊙(g W)·s          (K2b on the product)
    dW = gᵀ (M⊙x)·s         (K2b on x, then the product)

Where both dx and dW are needed (an inner layer) the two masked tensors
come from one launch of K2b's paired form, ``seeded_dropout_pair``, which
hashes each mask value once; where only dW is (the first layer, whose
input is data), from the single form. ``W`` is in the ``nn.Linear`` layout
(N, K). The two products of the backward stay ``torch.matmul``: the JAX
package computed them outside Pallas too.

Each kernel takes float32 or bfloat16 (the joint model's RNA encoder in
``compute_dtype: "bfloat16"``), ``x`` and ``W`` in one dtype: a kept bf16
value is ``float32(x)·s`` rounded once to bf16, K2a multiplies the bf16
values with float32 sums into a float32 output, K2b writes bf16. In bf16
the backward's products run in bf16 (float32 sums), so dx and dW come out
in the inputs' dtype, as JAX's autodiff of a bf16 layer gives them.

``dropout_matmul``, ``seeded_dropout`` and ``seeded_dropout_pair`` dispatch
on the device of their input: a CPU tensor goes to the plain version; a
CUDA tensor launches the kernel or raises. Each wrapper's ``launches``
counts its kernel's launches, in either dtype, and ``bf16_launches`` those
of its bf16 form.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: gidx = row·65536 + col: columns (with their offset) alias beyond this width
MAX_K = 1 << 16
_M32 = 0xFFFFFFFF

_lib: ctypes.CDLL | None = None


def keep_threshold(p: float) -> int:
    """keep iff hash >= threshold, so P(keep) = 1 − p."""
    return min(int(p * (1 << 32)), _M32)


def keep_scale(p: float) -> np.float32:
    """The float32 factor of a kept value."""
    return np.float32(1.0 / (1.0 - p))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a·b mod 2³²`` for int64 ``a`` in [0, 2³²) and a 32-bit constant
    ``b``, in 16-bit halves of ``b`` so no product passes 2⁴⁹."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + ((a * hi) & 0xFFFF) * 65536) & _M32


def keep_mask(rows: int, cols: int, seed: int, p: float,
              device: torch.device | str = "cpu", row0: int = 0,
              col0: int = 0) -> torch.Tensor:
    """(rows, cols) bool keep-mask of ``seed`` at drop probability ``p``:
    rows ``[row0, row0 + rows)`` and columns ``[col0, col0 + cols)`` of the
    mask."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    c = torch.arange(col0, col0 + cols, dtype=torch.int64, device=device)
    h = ((r[:, None] * 65536 + c[None, :]) & _M32) ^ ((int(seed) * 0x9E3779B1) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= keep_threshold(p)


def seeded_dropout_plain(x: torch.Tensor, seed: int, p: float, row0: int = 0,
                         col0: int = 0) -> torch.Tensor:
    """(M, K) ``x`` with the mask of ``seed`` at ``(row0, col0)`` applied
    and the kept values scaled (in float32, rounded once to ``x``'s dtype);
    ``x`` itself at ``p == 0``."""
    if p == 0:
        return x
    keep = keep_mask(x.shape[0], x.shape[1], seed, p, x.device, row0, col0)
    scale = torch.tensor(keep_scale(p), device=x.device)
    return torch.where(keep, (x.float() * scale).to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def seeded_dropout_pair_plain(a: torch.Tensor, b: torch.Tensor, seed: int,
                              p: float, row0: int = 0, col0: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``seeded_dropout_plain`` of two (M, K) tensors with one seed."""
    return (seeded_dropout_plain(a, seed, p, row0, col0),
            seeded_dropout_plain(b, seed, p, row0, col0))


def dropout_matmul_plain(x: torch.Tensor, weight: torch.Tensor, seed: int,
                         p: float, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """(M, K) ``x`` masked (at ``(row0, col0)``) and scaled, times the
    (N, K) ``weight`` transposed → (M, N) float32: the product in float32
    of the values in their dtype."""
    return seeded_dropout_plain(x, seed, p, row0, col0).float() @ weight.float().t()


#: the C entries' suffix per dtype
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a built library."""
    offsets = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    mask = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float] + offsets
    for suffix in _SUFFIX.values():
        fn = getattr(lib, f"dropout_matmul_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_int]
                       + offsets)
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"seeded_dropout_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + mask
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"seeded_dropout_pair_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + mask
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multimodalbrainsurvival_torch.kernels import build

        _lib = bind(build.load("dropout_matmul"))
    return _lib


def _check(x: torch.Tensor, p: float, *others: torch.Tensor, row0: int = 0,
           col0: int = 0) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if not 0.0 <= p < 1.0:
        raise ValueError(f"drop probability must be in [0, 1), got {p}")
    if row0 < 0 or col0 < 0:
        raise ValueError(f"the mask's offsets must be >= 0, got ({row0}, {col0})")
    if col0 + x.shape[1] > MAX_K:
        raise ValueError(f"col0 + K = {col0} + {x.shape[1]} > {MAX_K}: the mask's "
                         "column index would alias")
    for t in (x, *others):
        if t.dtype not in _SUFFIX:
            raise ValueError(f"the kernels take float32 or bfloat16, got {t.dtype}")
        if t.dtype != x.dtype:
            raise ValueError(f"all inputs must be {x.dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda":
        if not all(t.is_contiguous() for t in (x, *others)):
            raise ValueError("the kernels take contiguous inputs")
        size = x.element_size()
        if any(t.data_ptr() % size for t in (x, *others)):
            raise ValueError(f"the kernels take {x.dtype} inputs on {size}-byte "
                             "boundaries")
        if x.numel() >= 2**31 or any(t.numel() >= 2**31 for t in others):
            raise ValueError(f"shape {tuple(x.shape)} is beyond the kernel's range")


def dropout_matmul(x: torch.Tensor, weight: torch.Tensor, seed: int,
                   p: float, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """K2a: (M, K) ``x`` with the mask of ``seed`` at drop probability ``p``
    (its rows and columns at ``(row0, col0)``) applied, times the (N, K)
    ``weight`` transposed → (M, N) float32; both float32 or both bfloat16
    (on the card with K even). At ``p == 0`` a plain product."""
    _check(x, p, weight, row0=row0, col0=col0)
    if weight.dim() != 2 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"weight must be (N, {x.shape[1]}), got {tuple(weight.shape)}")
    if x.device.type == "cpu":
        return dropout_matmul_plain(x, weight, seed, p, row0, col0)
    (M, K), N = x.shape, weight.shape[0]
    if x.dtype == torch.bfloat16 and (K % 2 or x.data_ptr() % 4 or weight.data_ptr() % 4):
        raise ValueError(f"the bf16 kernel loads rows in 4-byte pieces: K = {K} must be "
                         "even and x and weight start on 4-byte boundaries")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_library(), f"dropout_matmul_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), M, N, K,
            int(seed) & _M32, keep_threshold(p), float(keep_scale(p)),
            int(p > 0), row0, col0, stream,
        )
    if err != 0:
        raise RuntimeError(f"dropout_matmul kernel launch failed: CUDA error {err}")
    dropout_matmul.launches += 1
    dropout_matmul.bf16_launches += x.dtype == torch.bfloat16
    return out


def seeded_dropout(x: torch.Tensor, seed: int, p: float, row0: int = 0,
                   col0: int = 0) -> torch.Tensor:
    """K2b: (M, K) float32 or bfloat16 ``x`` with the mask of ``seed`` at
    ``(row0, col0)`` applied and kept values scaled, bit for bit as the
    plain version; ``x`` itself at ``p == 0`` (no launch)."""
    _check(x, p, row0=row0, col0=col0)
    if x.device.type == "cpu" or p == 0:
        return seeded_dropout_plain(x, seed, p, row0, col0)
    out = torch.empty_like(x)
    _launch("seeded_dropout", x, x.data_ptr(), out.data_ptr(), *x.shape,
            seed=seed, p=p, row0=row0, col0=col0)
    seeded_dropout.launches += 1
    seeded_dropout.bf16_launches += x.dtype == torch.bfloat16
    return out


def seeded_dropout_pair(a: torch.Tensor, b: torch.Tensor, seed: int,
                        p: float, row0: int = 0, col0: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2b's paired form: two (M, K) tensors of one dtype with the one mask of
    ``seed`` applied, in one launch that hashes each mask value once; bit
    for bit ``seeded_dropout`` of each. ``(a, b)`` themselves at ``p == 0``
    (no launch)."""
    _check(a, p, b, row0=row0, col0=col0)
    if b.shape != a.shape:
        raise ValueError(f"both tensors must have one shape, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.device.type == "cpu" or p == 0:
        return seeded_dropout_pair_plain(a, b, seed, p, row0, col0)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    _launch("seeded_dropout_pair", a, a.data_ptr(), b.data_ptr(),
            out_a.data_ptr(), out_b.data_ptr(), *a.shape, seed=seed, p=p,
            row0=row0, col0=col0)
    seeded_dropout_pair.launches += 1
    seeded_dropout_pair.bf16_launches += a.dtype == torch.bfloat16
    return out_a, out_b


def _launch(entry: str, x: torch.Tensor, *args, seed: int, p: float, row0: int,
            col0: int) -> None:
    """Call the C entry ``<entry>_<dtype of x>`` with ``args``, then the mask
    of ``seed`` at ``p`` and ``(row0, col0)`` and the current stream; raise
    if the launch failed."""
    device = x.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), f"{entry}_{_SUFFIX[x.dtype]}")(
            *args, int(seed) & _M32, keep_threshold(p), float(keep_scale(p)), row0, col0,
            stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


for _fn in (dropout_matmul, seeded_dropout, seeded_dropout_pair):
    _fn.launches = _fn.bf16_launches = 0


class DropoutMatmul(torch.autograd.Function):
    """``dropout(x; seed, p) @ weightᵀ`` with the mask regenerated in the
    backward (``_bwd``, ``dropout_matmul.py:207-218``): K2a forward, K2b on
    ``g W`` for dx and on ``x`` for dW, both in one launch of the paired
    form. dx is skipped when ``x`` needs no gradient (the data entering the
    first layer), and then K2b's single form masks ``x`` alone. In bf16 the
    float32 output's gradient is rounded to bf16 and both products run in
    bf16 with float32 sums: dx and dW are bf16. ``(row0, col0)``: x's
    offset in the mask, the same in the forward and both backward masks."""

    @staticmethod
    def forward(ctx, x, weight, seed: int, p: float, row0: int = 0, col0: int = 0):
        ctx.save_for_backward(x, weight)
        ctx.mask = (seed, p, row0, col0)
        return dropout_matmul(x, weight, seed, p, row0, col0)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_dx and need_dw:
            dx, xm = seeded_dropout_pair(g @ weight, x, *ctx.mask)
            dw = g.t() @ xm
        elif need_dx:
            dx = seeded_dropout(g @ weight, *ctx.mask)
        elif need_dw:
            dw = g.t() @ seeded_dropout(x, *ctx.mask)
        return dx, dw, None, None, None, None
