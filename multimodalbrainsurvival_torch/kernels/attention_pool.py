"""Fused gated tanh-attention bag pool: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``fused_gated_attention_pool`` / ``_pool_forward``
(``multimodalbrainsurvival_tpu/ops/pallas/tanh_attention.py``, retired in
commit ``183b10c``; ``pallas_call`` at ``:111``). The kernel source is
``csrc/attention_pool.cu`` (its product is ``csrc/splitk_tn.cuh``); its
header says what bounds it on the card and what its design does about that.
In short: at the serving shape (B·bag = 256, D = 2048, bfloat16) the ideal
time is set by memory, 9.4 MB (mostly W) in 2.8 µs at 3.35 TB/s, against
2.2 µs for the 2.15 GFLOP of the projection at 989 TFLOP/s; the kernel runs
the projection on the tensor cores (bf16 ``wgmma``, or 3xTF32 in float32)
with D split over a cluster, so W is read once by a full wave of blocks.

``attention_pool`` dispatches on the device of its input: a CPU tensor goes
to ``attention_pool_plain``; a CUDA tensor launches the kernel or raises.
``attention_pool.launches`` counts kernel launches (one per call).

The kernel's outputs carry no gradient. ``AttentionPool`` (an
``autograd.Function``, called as ``pool``) runs ``attention_pool`` forward
and the analytic backward ``attention_pool_backward``, the port of the JAX
package's ``_pool_bwd`` (``tanh_attention.py:150-186`` at ``183b10c^``):
stock jnp there and plain PyTorch here, every product in float32 with TF32
off; it recomputes ``h = x Wᵀ`` instead of keeping kernel state.
``attention_pool_backward.calls`` counts its calls; it launches no kernel of
the port.
"""

from __future__ import annotations

import ctypes

import torch

#: the masked-logit fill of ``TanhAttention`` (``models/aggregators.py:30``)
NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def attention_pool_plain(x, weight, v, mask):
    """``TanhAttention`` + ``masked_bag_mean`` written out, in float32.

    ``x`` (B, bag, D); ``weight`` (D, D) in ``nn.Linear`` layout, so
    ``h = x @ weight.T``; ``v`` (D,); ``mask`` (B, bag) bool. Returns the
    (B, D) pooled embedding and the (B, bag) attention weights, float32.
    """
    x32 = x.float()
    mask = mask.bool()
    h = torch.tanh(x32 @ weight.float().t())
    logits = torch.where(mask, h @ v.float(), NEG_INF)
    weights = torch.softmax(logits, dim=1) * mask
    n = mask.float().sum(dim=1)
    # rescale by the real patch count (reference models.py:32), then the
    # masked mean over the bag
    out = x32 * weights[..., None] * n[:, None, None]
    m = mask.float()[..., None]
    pooled = (out * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    return pooled, weights


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a built library."""
    lib.attention_pool_col_tiles.argtypes = [ctypes.c_int]
    lib.attention_pool_col_tiles.restype = ctypes.c_int
    lib.attention_pool_forward.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.attention_pool_forward.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multimodalbrainsurvival_torch.kernels import build

        _lib = bind(build.load("attention_pool"))
    return _lib


def _check(x, weight, v, mask) -> None:
    if x.dim() != 3 or x.shape[1] == 0 or x.shape[2] == 0:
        raise ValueError(f"x must be (B, bag, D) with bag, D > 0, got {tuple(x.shape)}")
    B, bag, D = x.shape
    if tuple(weight.shape) != (D, D) or tuple(v.shape) != (D,):
        raise ValueError(
            f"weight must be ({D}, {D}) and v ({D},), got "
            f"{tuple(weight.shape)} and {tuple(v.shape)}"
        )
    if tuple(mask.shape) != (B, bag) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a ({B}, {bag}) bool tensor")
    for t in (weight, v, mask):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")


def attention_pool(x, weight, v, mask):
    """(B, bag, D) x, (D, D) ``nn.Linear``-layout weight, (D,) v, (B, bag)
    bool mask → ((B, D) pooled, (B, bag) attention weights), float32.

    On the card ``x`` and ``weight`` are float32 or bfloat16 of the same
    dtype, contiguous, and start on 16-byte boundaries with rows of a
    multiple of 16 bytes (D a multiple of 8 in bfloat16, of 4 in float32:
    the kernel loads them by TMA); ``v`` is read as float32.
    """
    _check(x, weight, v, mask)
    if x.device.type == "cpu":
        return attention_pool_plain(x, weight, v, mask)
    if x.device.type != "cuda":
        raise ValueError(f"attention_pool runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype:
        raise ValueError(
            "the kernel takes float32 or bfloat16 x and weight of one dtype, "
            f"got {x.dtype} and {weight.dtype}"
        )
    if not (x.is_contiguous() and weight.is_contiguous() and mask.is_contiguous()):
        raise ValueError("the kernel takes contiguous x, weight and mask")
    B, bag, D = x.shape
    if (D * x.element_size()) % 16 or x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError(
            f"the kernel loads x and weight by TMA: rows of D = {D} {x.dtype} "
            "values must be a multiple of 16 bytes and both must start on a "
            "16-byte boundary"
        )
    if B * bag * D >= 2**31 or bag * 4 > 227 * 1024:
        raise ValueError(f"shape {tuple(x.shape)} is beyond the kernel's range")
    lib = _library()
    v32 = v.float().contiguous()
    partial = torch.empty((lib.attention_pool_col_tiles(D), B * bag),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((B, D), dtype=torch.float32, device=x.device)
    attn = torch.empty((B, bag), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.attention_pool_forward(
            x.data_ptr(), weight.data_ptr(), v32.data_ptr(), mask.data_ptr(),
            partial.data_ptr(), out.data_ptr(), attn.data_ptr(),
            B, bag, D, _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_pool kernel launch failed: CUDA error {err}")
    attention_pool.launches += 1
    return out, attn


attention_pool.launches = 0


def attention_pool_backward(x, weight, v, mask, attn, g_out, g_attn):
    """Gradients of ``attention_pool`` → ``(dx, dweight, dv)``.

    ``attn`` is the forward's (B, bag) attention; ``g_out`` (B, D) and
    ``g_attn`` (B, bag) the cotangents of its two outputs. With ``h = x
    Wᵀ``, ``th = tanh(h)`` and ``vs = v ⊙ (1 - th²)``: ``g_w = g_out·x_t +
    g_attn``, the masked-softmax backward ``dl = w ⊙ (g_w - Σ w g_w)``
    (zero on pads), then ``dx = w g_out + dl (vs W)``, ``dW = (dl vs)ᵀ x``
    (``nn.Linear`` layout, the transpose of the JAX package's ``dW``) and
    ``dv = Σ dl th``. Float32 throughout, TF32 off; ``dx`` in ``x.dtype``,
    ``dweight`` in ``weight.dtype``, ``dv`` in ``v.dtype``.
    """
    attention_pool_backward.calls += 1
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x32, w32, v32 = x.float(), weight.float(), v.float()
        B, bag, D = x.shape
        th = torch.tanh(x32 @ w32.t())
        vs = (1.0 - th * th) * v32
        attn, g_out = attn.float(), g_out.float()
        g_w = torch.einsum("bd,btd->bt", g_out, x32) + g_attn.float()
        dl = attn * (g_w - (attn * g_w).sum(dim=1, keepdim=True))
        dl = torch.where(mask, dl, torch.zeros_like(dl))
        dlvs = dl[..., None] * vs
        dx = dlvs @ w32 + attn[..., None] * g_out[:, None, :]
        dweight = dlvs.reshape(B * bag, D).t() @ x32.reshape(B * bag, D)
        dv = (dl[..., None] * th).sum(dim=(0, 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return dx.to(x.dtype), dweight.to(weight.dtype), dv.to(v.dtype)


attention_pool_backward.calls = 0


class AttentionPool(torch.autograd.Function):
    """``attention_pool`` with a gradient: the kernel (or, on the CPU, its
    plain version) forward, ``attention_pool_backward`` backward. Saves x,
    weight, v, mask and the attention, not ``h``. The mask gets no
    gradient. Autograd hands the backward a zero cotangent for an output
    that took no part in the loss."""

    @staticmethod
    def forward(ctx, x, weight, v, mask):
        out, attn = attention_pool(x, weight, v, mask)
        ctx.save_for_backward(x, weight, v, mask, attn)
        return out, attn

    @staticmethod
    def backward(ctx, g_out, g_attn):
        x, weight, v, mask, attn = ctx.saved_tensors
        dx, dweight, dv = attention_pool_backward(x, weight, v, mask, attn,
                                                  g_out, g_attn)
        return dx, dweight, dv, None


#: ``attention_pool`` differentiable in x, weight and v, on both devices
pool = AttentionPool.apply
