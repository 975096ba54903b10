"""Device selection and float32 precision flags for every entry point."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (the default of every entry point) or ``"cpu"``.

    Raises when a CUDA device is asked for and none is present: a run never
    carries on silently on the CPU.
    """
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU"
        )
    configure_precision()
    return device


def configure_precision() -> None:
    """Full float32 in matrix products AND convolutions.

    A float32 matmul on the card is full precision by default, but cuDNN
    convolutions default to TF32 (about three decimal digits), which would
    break float32 parity with the reference. bfloat16 compute is asked for
    explicitly through ``compute_dtype`` instead.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compute_dtype(name: str) -> torch.dtype:
    """Config ``compute_dtype`` string → torch dtype (float32 by default)."""
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported compute_dtype {name!r}")
