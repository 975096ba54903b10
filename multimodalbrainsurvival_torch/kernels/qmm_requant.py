"""int8 product with a fused requant epilogue (K3): CUDA kernel wrapper +
plain version.

Replaces the TPU kernel ``qmm_requant`` / ``_kern``
(``benchmarks/int8_pallas_probe.py:55,45``; ``pallas_call`` at ``:80``),
which computes the live 1×1 stride-1 branch of the JAX package's int8 conv
(``models/quantize.py::_qconv_q``): an int8 × int8 → int32 product, then
``acc·s + b → relu? → round (half to even) → clip ±127 → int8``. The kernel
source is ``csrc/qmm_requant.cu``; its header says what bounds it on the
card and what its design does about that.

PyTorch has no int8 convolution on the card, so the kernel is an implicit
GEMM over an NHWC input and also takes the 3×3 convs and the 1×1 stride-2
downsamples: ``qconv_requant`` is the conv form, ``qmm_requant`` the plain
product (a 1×1 stride-1 conv over a 1×1 image).

Layouts: activations are NHWC int8 (``channels_last``), so a 1×1 stride-1
conv's A is the activation itself, (M, K). Weights are (N, kh, kw, C) int8,
that is (N, K) with K in (kh, kw, C) order, the ``nn.Linear`` layout of the
product. ``scale`` and ``bias`` are the float32 per-column epilogue, already
combined by the caller (``models/quantize.py``).

Both wrappers dispatch on the device of their input: a CPU tensor goes to the
plain version; a CUDA tensor launches the kernel or raises.
``qmm_requant.launches`` counts kernel launches, from either form.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_lib: ctypes.CDLL | None = None


def _epilogue(acc, scale, bias, relu: bool) -> torch.Tensor:
    """float32 ``acc·s + b`` as two separate roundings (no FMA), relu, round
    half to even, clip ±127 → int8."""
    y = acc.float() * scale + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.round(y).clamp_(-127, 127).to(torch.int8)


def qmm_requant_plain(a, w, scale, bias, relu: bool = True) -> torch.Tensor:
    """(M, K) int8 ``a`` × (N, K) int8 ``w`` → (M, N) int8.

    The operands are widened to float64 before the product: int8 @ int8
    returns int8 and wraps, and float32 is exact only below 2**24, which a
    sum of K = 4,608 products of ±127 exceeds; float64 is exact here on the
    CPU and on the card, in any order of summation.
    """
    acc = a.double() @ w.double().t()
    return _epilogue(acc, scale, bias, relu)


def im2col(x, kh: int, kw: int, stride: int, padding: int) -> torch.Tensor:
    """NHWC ``x`` → (N·Ho·Wo, kh·kw·C) rows in the kernel's k order."""
    x = F.pad(x, (0, 0, padding, padding, padding, padding))
    cols = x.unfold(1, kh, stride).unfold(2, kw, stride)  # N,Ho,Wo,C,kh,kw
    n, ho, wo = cols.shape[:3]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, -1)


def qconv_requant_plain(x, w, scale, bias, *, stride: int = 1,
                        padding: int = 0, relu: bool = True) -> torch.Tensor:
    """NHWC int8 (B, H, W, C) conv (N, kh, kw, C) int8 → (B, Ho, Wo, N)
    int8, zero padding, through an exact float64 im2col product."""
    n_out, kh, kw, _ = w.shape
    cols = im2col(x.double(), kh, kw, stride, padding)
    acc = cols @ w.double().reshape(n_out, -1).t()
    y = _epilogue(acc, scale, bias, relu)
    ho = (x.shape[1] + 2 * padding - kh) // stride + 1
    wo = (x.shape[2] + 2 * padding - kw) // stride + 1
    return y.reshape(x.shape[0], ho, wo, n_out)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multimodalbrainsurvival_torch.kernels import build

        lib = build.load("qmm_requant")
        lib.qconv_requant_s8.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        )
        lib.qconv_requant_s8.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, w, scale, bias) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(
            f"x must be NHWC (B, H, W, C) and w (N, kh, kw, C), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"x and w must be int8, got {x.dtype} and {w.dtype}")
    if w.shape[3] != x.shape[3]:
        raise ValueError(f"channels differ: x {tuple(x.shape)}, w {tuple(w.shape)}")
    n_out = w.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (n_out,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a ({n_out},) float32 tensor")
    for t in (w, scale, bias):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")


def qconv_requant(x, w, scale, bias, *, stride: int = 1, padding: int = 0,
                  relu: bool = True) -> torch.Tensor:
    """int8 NHWC conv with the fused requant epilogue.

    ``x`` (B, H, W, C) int8; ``w`` (N, kh, kw, C) int8; ``scale``, ``bias``
    (N,) float32 → (B, Ho, Wo, N) int8, zero padding ``padding`` on each
    side. On the card every input is contiguous.
    """
    _check(x, w, scale, bias)
    if x.device.type == "cpu":
        return qconv_requant_plain(x, w, scale, bias, stride=stride,
                                   padding=padding, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_requant runs on cpu or cuda, not {x.device}")
    if not all(t.is_contiguous() for t in (x, w, scale, bias)):
        raise ValueError("the kernel takes contiguous x, w, scale and bias")
    batch, H, W, C = x.shape
    n_out, kh, kw, _ = w.shape
    ho = (H + 2 * padding - kh) // stride + 1
    wo = (W + 2 * padding - kw) // stride + 1
    if stride < 1 or padding < 0 or ho < 1 or wo < 1:
        raise ValueError(f"bad geometry: stride {stride}, padding {padding}, "
                         f"input {tuple(x.shape)}, kernel {tuple(w.shape)}")
    if max(batch * ho * wo, kh * kw * C, x.numel(), batch * ho * wo * n_out) >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} is beyond the kernel's range")
    out = torch.empty((batch, ho, wo, n_out), dtype=torch.int8, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qconv_requant_s8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), batch, H, W, C, kh, kw, stride, padding, ho, wo,
            n_out, int(relu), stream,
        )
    if err != 0:
        raise RuntimeError(f"qmm_requant kernel launch failed: CUDA error {err}")
    qmm_requant.launches += 1
    return out


def qmm_requant(a, w, scale, bias, relu: bool = True) -> torch.Tensor:
    """(M, K) int8 ``a`` × (N, K) int8 ``w`` with the fused requant
    epilogue → (M, N) int8 (the TPU kernel's function, with ``w`` in
    ``nn.Linear`` layout)."""
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"a must be (M, K) and w (N, K), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if a.device.type == "cuda" and not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous a and w")
    (M, K), N = a.shape, w.shape[0]
    out = qconv_requant(a.reshape(M, 1, 1, K), w.reshape(N, 1, 1, -1),
                        scale, bias, relu=relu)
    return out.reshape(M, N)


qmm_requant.launches = 0
