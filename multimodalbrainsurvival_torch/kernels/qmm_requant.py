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
product (a 1×1 stride-1 conv over a 1×1 image), and
``qconv_residual_requant`` the residual form: the conv with relu off, then
the JAX package's ``_residual_relu_q`` (``models/quantize.py:214-221``)
with the int8 skip branch in the same epilogue, so the last conv of a block
writes the block's output directly.

``stem_requant_pool`` is the int8 stem's pass after its float32 conv: bias,
ReLU, requant to the stem site, the 3×3 stride-2 max-pool (padding 1) on
the int8 values and the NHWC layout, in one kernel of the same source.

Layouts: activations are NHWC int8 (``channels_last``), so a 1×1 stride-1
conv's A is the activation itself, (M, K). Weights are (N, kh, kw, C) int8,
that is (N, K) with K in (kh, kw, C) order, the ``nn.Linear`` layout of the
product. ``scale`` and ``bias`` are the float32 per-column epilogue, already
combined by the caller (``models/quantize.py``).

Every wrapper dispatches on the device of its input: a CPU tensor goes to
the plain version; a CUDA tensor launches the kernel or raises.
``qmm_requant.launches`` counts the product's launches, from any of its
three forms, ``qconv_residual_requant.launches`` those of the residual form
alone, and ``stem_requant_pool.launches`` the stem pass's.
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


def residual_relu_q(t_q, s_t, r_q, s_r, s_out) -> torch.Tensor:
    """relu(t + r) from two int8 branches with their own scales, requantized
    to the output site: two float32 products and a sum, each rounded (no
    FMA), then a true division (the plain reference of the residual form's
    epilogue)."""
    y = t_q.float() * s_t + r_q.float() * s_r
    return torch.round(torch.relu(y) / s_out).clamp_(-127, 127).to(torch.int8)


def qconv_residual_requant_plain(x, w, scale, bias, r_q, s_t, s_r, s_out, *,
                                 stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The residual form in plain PyTorch: ``qconv_requant_plain`` with relu
    off, then the residual epilogue on ``r_q``."""
    t = qconv_requant_plain(x, w, scale, bias, stride=stride, padding=padding,
                            relu=False)
    return residual_relu_q(t, s_t, r_q, s_r, s_out)


def stem_requant_pool_plain(y, bias, s) -> torch.Tensor:
    """(B, C, H, W) float32 stem conv output → (B, Ho, Wo, C) int8 NHWC:
    ``requant(relu(y + b), s)``, then the 3×3 stride-2 max-pool with
    padding 1 on the int8 values (exact in float32; every window holds a
    real pixel, so the -inf padding acts as the JAX package's -128)."""
    v = torch.clamp_min(y + bias[:, None, None], 0.0)
    y_q = torch.round(v / s).clamp(-127, 127).to(torch.int8)
    y_q = F.max_pool2d(y_q.float(), 3, 2, 1).to(torch.int8)
    return y_q.permute(0, 2, 3, 1).contiguous()


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multimodalbrainsurvival_torch.kernels import build

        lib = build.load("qmm_requant")
        lib.qconv_requant_s8.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        )
        lib.qconv_residual_requant_s8.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        )
        lib.stem_requant_pool_s8.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        for fn in (lib.qconv_requant_s8, lib.qconv_residual_requant_s8,
                   lib.stem_requant_pool_s8):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_scalar(name, t, device) -> None:
    if t.numel() != 1 or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be one float32 value on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


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


def _card_geometry(x, w, scale, bias, stride, padding) -> tuple:
    """The kernel's checks on the card; returns (batch, H, W, C, N, kh, kw,
    Ho, Wo)."""
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
    return batch, H, W, C, n_out, kh, kw, ho, wo


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
    batch, H, W, C, n_out, kh, kw, ho, wo = _card_geometry(
        x, w, scale, bias, stride, padding)
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


def qconv_residual_requant(x, w, scale, bias, r_q, s_t, s_r, s_out, *,
                           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The residual form: the int8 conv with relu off (``t`` at ``s_t``),
    then ``relu(t·s_t + r_q·s_r)`` requantized to ``s_out``.

    ``r_q`` (B, Ho, Wo, N) int8, the skip branch at its scale ``s_r``;
    ``s_t``, ``s_r``, ``s_out``: one float32 each on x's device, read by the
    kernel there (no host sync). Counts on ``qmm_requant.launches``.
    """
    _check(x, w, scale, bias)
    for name, t in (("s_t", s_t), ("s_r", s_r), ("s_out", s_out)):
        _check_scalar(name, t, x.device)
    if x.device.type == "cpu":
        return qconv_residual_requant_plain(x, w, scale, bias, r_q, s_t, s_r,
                                            s_out, stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_residual_requant runs on cpu or cuda, not {x.device}")
    batch, H, W, C, n_out, kh, kw, ho, wo = _card_geometry(
        x, w, scale, bias, stride, padding)
    if (r_q.dtype != torch.int8 or tuple(r_q.shape) != (batch, ho, wo, n_out)
            or r_q.device != x.device or not r_q.is_contiguous()):
        raise ValueError(f"r_q must be a contiguous ({batch}, {ho}, {wo}, {n_out}) "
                         f"int8 tensor on {x.device}, got {r_q.dtype} "
                         f"{tuple(r_q.shape)} on {r_q.device}")
    out = torch.empty((batch, ho, wo, n_out), dtype=torch.int8, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qconv_residual_requant_s8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            r_q.data_ptr(), s_t.data_ptr(), s_r.data_ptr(), s_out.data_ptr(),
            out.data_ptr(), batch, H, W, C, kh, kw, stride, padding, ho, wo,
            n_out, stream,
        )
    if err != 0:
        raise RuntimeError(f"qmm_requant kernel launch failed: CUDA error {err}")
    qmm_requant.launches += 1
    qconv_residual_requant.launches += 1
    return out


def stem_requant_pool(y, bias, s) -> torch.Tensor:
    """The int8 stem's pass after its conv: ``y`` (B, C, H, W) float32 (on
    the card, NHWC in memory saves a copy), ``bias`` (C,) float32, ``s`` the
    stem site's scale (one float32) → (B, Ho, Wo, C) int8 NHWC."""
    if y.dim() != 4 or y.dtype != torch.float32:
        raise ValueError(f"y must be a 4-d float32 tensor, got {y.dtype} {tuple(y.shape)}")
    batch, C, H, W = y.shape
    if tuple(bias.shape) != (C,) or bias.dtype != torch.float32 or bias.device != y.device:
        raise ValueError(f"bias must be a ({C},) float32 tensor on {y.device}")
    _check_scalar("s", s, y.device)
    if y.device.type == "cpu":
        return stem_requant_pool_plain(y, bias, s)
    if y.device.type != "cuda":
        raise ValueError(f"stem_requant_pool runs on cpu or cuda, not {y.device}")
    if y.numel() >= 2**31:
        raise ValueError(f"shape {tuple(y.shape)} is beyond the kernel's range")
    y = y.contiguous(memory_format=torch.channels_last)
    bias = bias.contiguous()
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    out = torch.empty((batch, ho, wo, C), dtype=torch.int8, device=y.device)
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.stem_requant_pool_s8(y.data_ptr(), bias.data_ptr(), s.data_ptr(),
                                       out.data_ptr(), batch, H, W, C, stream)
    if err != 0:
        raise RuntimeError(f"stem_requant_pool kernel launch failed: CUDA error {err}")
    stem_requant_pool.launches += 1
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
qconv_residual_requant.launches = 0
stem_requant_pool.launches = 0
