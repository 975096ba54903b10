"""int8 (W8A8) post-training quantization of the ResNet serving path.

Counterpart of ``multimodalbrainsurvival_tpu/models/quantize.py:46-365,
452-478``: int8 serving and the int8 frozen trunk of training
(``quantized_trunk``, ``quantize_trunk_for_training``; the RNA MLP comes
with its slice, ROADMAP.md). The scheme is the JAX package's:

- **weights**: symmetric int8 with a per-output-channel scale, from the
  BN-folded kernels (``models/folding.py``);
- **activations**: symmetric int8 with per-tensor static scales
  (``amax / 127``) calibrated by a float32 forward that records the abs-max
  at every site: ``stem``, and per block ``.r1``/``.r2`` (post-relu
  intermediates), ``.t`` and ``.skip`` (the signed residual branches) and
  ``.out``;
- **convs**: int8 × int8 → int32, then one epilogue with the pre-combined
  per-channel scale ``(s_in·ws)/s_out`` and bias ``b/s_out``, relu,
  round half to even, clip ±127 → int8 (``kernels/qmm_requant.py``, K3: a
  hand-written kernel on the card for every conv, 1×1 and 3×3 alike);
- the last conv of every block (and its downsample, where there is one)
  ends in the residual form of K3 (``qconv_residual_requant``): relu off,
  then the residual add, ReLU and requant to the ``.out`` site in the same
  epilogue, bit-identical to ``qconv_q`` followed by
  ``kernels/qmm_requant.py::residual_relu_q``;
- the stem is a float32 conv of the bfloat16-rounded input and dequantized
  kernel (the JAX package's bf16 operands with float32 sums), then one pass
  (``stem_requant_pool``, a kernel on the card) requantizes it to the
  ``stem`` site and max-pools the int8 values into NHWC.

Layouts are the port's: the float input is NCHW (``channels_last``), int8
activations are NHWC, conv weights are (O, kh, kw, I) int8. The qtree is
``{"conv1": {"k", "ws", "b"}, "layer1_0": {"conv1", ..., "downsample_conv"},
..., "scales": {site: 0-dim float32}}``, the JAX package's keys
(``models/convert.py::flax_qtree_to_torch`` carries one across).
Calibration takes the state_dict of a ``fold_bn=True`` ResNet.

Works for the whole family (18/34 basic blocks, 50/101/152 bottleneck) and
any ``in_channels``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multimodalbrainsurvival_torch.kernels.qmm_requant import (
    qconv_requant,
    qconv_residual_requant,
    stem_requant_pool,
)
from multimodalbrainsurvival_torch.models.folding import fold_resnet_state_dict
from multimodalbrainsurvival_torch.ops.image import preprocess_patches

STAGE_SIZES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
BASIC_ARCHS = ("resnet18", "resnet34")
EPS = 1e-8  # scale floor: a dead channel or site must not divide by zero

# qtree block keys (the JAX package's) → the port's module names
_BLOCK_CONVS = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
                "downsample_conv": "downsample.0"}


def _blocks(arch: str):
    """(qtree key, module scope, stride, stage index) of every block."""
    for i, n_blocks in enumerate(STAGE_SIZES[arch]):
        for j in range(n_blocks):
            yield f"layer{i + 1}_{j}", f"layer{i + 1}.{j}", (2 if i > 0 and j == 0 else 1), i


# --- float forward with activation-range capture ---------------------------


def _fconv(x, state, scope, stride=1, padding=0):
    return F.conv2d(x, state[f"{scope}.weight"].float(),
                    state[f"{scope}.bias"].float(), stride=stride,
                    padding=padding)


@torch.inference_mode()
def float_extract_amax(state: dict, x: torch.Tensor, *, arch: str = "resnet50"):
    """Folded-ResNet float32 forward that also returns per-site abs-maxes.

    ``state``: the ``state_dict`` of a ``fold_bn=True`` ResNet; ``x``: the
    preprocessed (N, C, H, W) input. Returns ``((N, D) float32 features,
    {site: 0-dim amax})``; the features are the folded ``extract``'s.
    """
    basic = arch in BASIC_ARCHS
    amax = {"in": x.abs().max().float()}
    x = x.float()
    y = F.relu(_fconv(x, state, "conv1", stride=2, padding=3))
    amax["stem"] = y.max()
    y = F.max_pool2d(y, 3, 2, 1)
    for ln, scope, stride, _ in _blocks(arch):
        if basic:
            t = F.relu(_fconv(y, state, f"{scope}.conv1", stride, 1))
            amax[f"{ln}.r1"] = t.max()
            t = _fconv(t, state, f"{scope}.conv2", 1, 1)
        else:
            t = F.relu(_fconv(y, state, f"{scope}.conv1"))
            amax[f"{ln}.r1"] = t.max()
            t = F.relu(_fconv(t, state, f"{scope}.conv2", stride, 1))
            amax[f"{ln}.r2"] = t.max()
            t = _fconv(t, state, f"{scope}.conv3")
        # the pre-activation branches are signed: calibrate |.|
        amax[f"{ln}.t"] = t.abs().max()
        if f"{scope}.downsample.0.weight" in state:
            r = _fconv(y, state, f"{scope}.downsample.0", stride)
            amax[f"{ln}.skip"] = r.abs().max()
        else:
            r = y
        y = F.relu(t + r)
        amax[f"{ln}.out"] = y.max()
    return y.mean(dim=(2, 3)), amax


def merge_amax(dicts: list[dict]) -> dict[str, float]:
    """Elementwise max over per-batch amax dicts (float32 values)."""
    return {k: max(float(d[k]) for d in dicts) for k in dicts[0]}


# --- weight quantization ----------------------------------------------------


def quantize_conv(weight: torch.Tensor, bias: torch.Tensor) -> dict:
    """OIHW float conv → ``{"k": (O, kh, kw, I) int8, "ws": (O,) float32,
    "b": (O,) float32}``, symmetric per output channel."""
    k = weight.float()
    ws = torch.clamp(k.abs().amax(dim=(1, 2, 3)), min=EPS) / 127.0
    kq = torch.round(k / ws[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return {"k": kq.permute(0, 2, 3, 1).contiguous(), "ws": ws,
            "b": bias.float().clone()}


def quantize_resnet(state: dict, amax: dict, *, arch: str = "resnet50") -> dict:
    """Folded ResNet ``state_dict`` + calibrated amaxes → int8 qtree, on the
    device of the weights."""
    device = state["conv1.weight"].device
    qt: dict = {"conv1": quantize_conv(state["conv1.weight"], state["conv1.bias"])}
    for ln, scope, _, _ in _blocks(arch):
        qt[ln] = {
            name: quantize_conv(state[f"{scope}.{mod}.weight"],
                                state[f"{scope}.{mod}.bias"])
            for name, mod in _BLOCK_CONVS.items()
            if f"{scope}.{mod}.weight" in state
        }
    # amax / 127 in double, rounded once to float32, as the JAX package does
    qt["scales"] = {
        site: torch.tensor(max(float(v), EPS) / 127.0, dtype=torch.float32,
                           device=device)
        for site, v in amax.items()
    }
    return qt


# --- int8 forward -------------------------------------------------------------


def qconv_q(x_q, s_in, cp: dict, s_out, *, stride: int = 1, padding: int = 0,
            relu: bool = True) -> torch.Tensor:
    """NHWC int8 conv whose epilogue lands directly at an int8 tensor of
    scale ``s_out`` (K3 on the card)."""
    scale = (s_in * cp["ws"]) / s_out
    bias = cp["b"] / s_out
    return qconv_requant(x_q, cp["k"], scale, bias, stride=stride,
                         padding=padding, relu=relu)


def qconv_residual_q(x_q, s_in, cp: dict, s_t, r_q, s_r, s_out, *,
                     stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``residual_relu_q(qconv_q(x_q, s_in, cp, s_t, relu=False), s_t, r_q,
    s_r, s_out)`` in one launch of K3's residual form."""
    scale = (s_in * cp["ws"]) / s_t
    bias = cp["b"] / s_t
    return qconv_residual_requant(x_q, cp["k"], scale, bias, r_q, s_t, s_r,
                                  s_out, stride=stride, padding=padding)


def quantized_stages(qtree: dict, x: torch.Tensor, *, stages: int,
                     arch: str = "resnet50"):
    """int8 stem + the first ``stages`` residual stages of (N, C, H, W)
    float ``x``; returns ``(y_q, s)``, the NHWC int8 feature map and its
    scale."""
    basic = arch in BASIC_ARCHS
    s = qtree["scales"]
    cp = qtree["conv1"]
    kb = (cp["k"].float() * cp["ws"][:, None, None, None]).to(torch.bfloat16)
    # bfloat16 operands, float32 products and sums (TF32 is off)
    y = F.conv2d(x.to(torch.bfloat16).float(), kb.float().permute(0, 3, 1, 2),
                 stride=2, padding=3)
    # bias, relu, requant to the stem site, then the max-pool on the int8
    # values, NHWC out
    y_q = stem_requant_pool(y, cp["b"], s["stem"])
    s_in = s["stem"]
    for ln, _, stride, i in _blocks(arch):
        if i >= stages:
            break
        bq = qtree[ln]
        s_out, s_t = s[f"{ln}.out"], s[f"{ln}.t"]
        if "downsample_conv" in bq:
            s_r = s[f"{ln}.skip"]
            r_q = qconv_q(y_q, s_in, bq["downsample_conv"], s_r, stride=stride,
                          relu=False)
        else:
            # identity skip: the block input is already int8 at s_in
            s_r, r_q = s_in, y_q
        # the block's last conv ends in the residual add (relu(t + r),
        # requantized to s_out)
        if basic:
            t_q = qconv_q(y_q, s_in, bq["conv1"], s[f"{ln}.r1"],
                          stride=stride, padding=1)
            y_q = qconv_residual_q(t_q, s[f"{ln}.r1"], bq["conv2"], s_t, r_q,
                                   s_r, s_out, padding=1)
        else:
            t_q = qconv_q(y_q, s_in, bq["conv1"], s[f"{ln}.r1"])
            t_q = qconv_q(t_q, s[f"{ln}.r1"], bq["conv2"], s[f"{ln}.r2"],
                          stride=stride, padding=1)
            y_q = qconv_residual_q(t_q, s[f"{ln}.r2"], bq["conv3"], s_t, r_q,
                                   s_r, s_out)
        s_in = s_out
    return y_q, s_in


def quantized_extract(qtree: dict, x: torch.Tensor, *,
                      arch: str = "resnet50") -> torch.Tensor:
    """(N, C, H, W) preprocessed float input → (N, D) float32 embedding
    through the int8 encoder; the last feature map is dequantized by the
    global average pool."""
    y_q, s_in = quantized_stages(qtree, x, stages=len(STAGE_SIZES[arch]),
                                 arch=arch)
    return y_q.float().mean(dim=(1, 2)) * s_in


def quantized_trunk(qtree: dict, x: torch.Tensor, *, stages: int,
                    arch: str = "resnet50",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 frozen prefix of ``quantize_trunk: "int8"`` training: the
    stem and the first ``stages`` residual stages of (N, C, H, W) float
    ``x`` through K3, dequantized to an (N, c, h, w) ``dtype`` feature map
    in ``channels_last`` memory, from which ``ResNet.extract_tail`` goes
    on. No gradient flows into it; the frozen stages' BatchNorm running
    statistics no longer update (the JAX package's documented deviation:
    the reference keeps updating them under the freeze)."""
    with torch.no_grad():
        y_q, s = quantized_stages(qtree, x, stages=stages, arch=arch)
        y = (y_q.float() * s).to(dtype)
    return y.permute(0, 3, 1, 2)


@torch.inference_mode()
def quantize_trunk_for_training(resnet: torch.nn.Module, patch_bags_u8, *,
                                arch: str = "resnet50", augment: bool = True,
                                seed: int = 0) -> dict:
    """Fold, calibrate and quantize the ResNet of a model at training start
    (JAX ``quantize_trunk_for_training``): its BatchNorms are folded with
    their current running statistics, and the activation ranges are
    calibrated on train-preprocessed pixels (float32; with ``augment``, the
    flips and jitter drawn from a generator on the weights' device seeded
    with ``seed``), so they cover what the trunk sees each step. Valid
    because the frozen prefix never changes. Returns the qtree for
    ``quantized_trunk``."""
    state = fold_resnet_state_dict(
        {k: v.float() for k, v in resnet.state_dict().items()})
    device = state["conv1.weight"].device
    generator = torch.Generator(device=device).manual_seed(seed) if augment else None
    dicts = []
    for bag in patch_bags_u8:
        u8 = torch.from_numpy(np.asarray(bag)).to(device)
        x = preprocess_patches(u8.reshape((-1,) + tuple(u8.shape[-3:])),
                               dtype=torch.float32, train=augment,
                               generator=generator)
        dicts.append(float_extract_amax(state, x, arch=arch)[1])
    return quantize_resnet(state, merge_amax(dicts), arch=arch)


@torch.inference_mode()
def quantize_mil_resnet(resnet: torch.nn.Module, patch_bags_u8, *,
                        arch: str = "resnet50") -> dict:
    """Calibrate and quantize a ``fold_bn=True`` ResNet on its device.

    ``patch_bags_u8``: raw uint8 ``(B, bag, H, W, C)`` (or ``(N, H, W, C)``)
    calibration batches as the loader yields them; they are preprocessed in
    float32 (eval mode) here, as the serving path preprocesses its input.
    """
    state = {k: v.float() for k, v in resnet.state_dict().items()}
    device = state["conv1.weight"].device
    dicts = []
    for bag in patch_bags_u8:
        u8 = torch.from_numpy(np.asarray(bag)).to(device)
        x = preprocess_patches(u8.reshape((-1,) + tuple(u8.shape[-3:])),
                               dtype=torch.float32)
        dicts.append(float_extract_amax(state, x, arch=arch)[1])
    return quantize_resnet(state, merge_amax(dicts), arch=arch)
