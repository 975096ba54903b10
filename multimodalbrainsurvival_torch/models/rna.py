"""RNA-seq encoder: 12,778-gene expression vector → 2048-d embedding → Cox head.

Counterpart of ``multimodalbrainsurvival_tpu/models/rna.py:22-66``. The
layers are the reference's own (``2_GeneExpression/1_GeneExpress_train.py:
247-257``): ``rna_mlp = Sequential(Dropout, Linear(12778, 4096), ReLU,
Dropout, Linear(4096, 2048))`` and ``final_mlp = Sequential(Linear(2048,
1))``, so the ``state_dict`` keys are ``rna_mlp.1.*``, ``rna_mlp.4.*`` and
``final_mlp.0.*`` and a reference ``.pt`` loads as it is.

In train mode each Dropout → Linear pair runs as one ``DropoutMatmul``
(K2: the mask hashed inside the product, regenerated in the backward) with
the ``nn.Dropout``'s ``p``, and one seed per layer per call, drawn from the
caller's ``torch.Generator`` (or given as ``seed``); that is the only way
train mode reaches the Linear layers. In eval mode each Linear is
``F.linear``.

The encoder computes in ``dtype``, as the JAX ``RNAEncoder(dtype=...)``
does: float32 (``rna_train``), or bfloat16 (the joint model under
``compute_dtype: "bfloat16"``), where the input and the float32 weights are
cast to bf16 each call (the casts carry the gradient to the float32
leaves), each layer's float32 product is rounded to bf16 and its bias
added in bf16 (flax ``Dense(dtype=bf16)``), and the output is float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodalbrainsurvival_torch.kernels.dropout_matmul import DropoutMatmul
from multimodalbrainsurvival_torch.parallel import mesh as parallel

#: the reference's gene count (``1_GeneExpress_train.py:247``)
RNA_GENES = 12778


def draw_seed(generator: torch.Generator | None) -> int:
    """A 31-bit base seed for K2's masks from ``generator`` (the default CPU
    generator for None). A draw from a CUDA generator waits for the card:
    the callers draw before they queue a step's work."""
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2**31, (), generator=generator, device=device))


def dropout_linears(layers: nn.Sequential, y: torch.Tensor, training: bool,
                    base: int | None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Run a ``Dropout → Linear (→ activation …)`` stack on ``y``: in train
    mode each Dropout → Linear pair as one ``DropoutMatmul`` seeded ``base
    + i`` for the i-th Linear (distinct seeds: equal seeds would give equal
    masks on the columns the layers share), its float32 product rounded to
    ``dtype`` and the bias added in ``dtype``; in eval mode ``F.linear`` in
    ``dtype``. The operands are cast to ``dtype`` (bf16 or float32).

    Under a data-parallel placement (``parallel.activate``) ``y`` is the
    rank's rows of the global batch, and each mask is taken at the rank's
    first row (``row0``). A stack sharded by ``parallel/sharding.py``
    (``layers.tp``, a mesh) runs tensor-parallel over its ``mp`` group:
    even Linears on their local output rows, odd ones on their local input
    columns with the mask at ``col0 = mp_rank · K``, their partial products
    summed over ``mp`` before the bias; an odd depth gathers the last
    activation's columns."""
    y = y.to(dtype)
    tp = getattr(layers, "tp", None)
    row0 = parallel.row_offset(y.shape[0])
    p, layer = 0.0, 0
    for m in layers:
        if isinstance(m, nn.Dropout):
            p = m.p
        elif isinstance(m, nn.Linear):
            w, b = m.weight.to(dtype), m.bias.to(dtype)
            if tp is None:
                if training:
                    y = DropoutMatmul.apply(y.contiguous(), w.contiguous(), base + layer, p,
                                            row0).to(dtype) + b
                else:
                    y = F.linear(y, w, b)
            elif layer % 2 == 0:  # column-parallel: y whole, w's local output rows
                y = parallel.copy_to(y, tp.mp_group)
                y = _product(y, w, training, base, layer, p, row0, 0).to(dtype) + b
            else:  # row-parallel: y's and w's local hidden columns
                part = _product(y, w, training, base, layer, p, row0,
                                tp.mp_rank * y.shape[1])
                y = parallel.reduce_from(part, tp.mp_group).to(dtype) + b
            p, layer = 0.0, layer + 1
        else:
            y = m(y)
    if tp is not None and layer % 2:
        y = parallel.gather(y, tp.mp_group, 1)
    return y


def _product(y, w, training: bool, base, layer: int, p: float, row0: int, col0: int):
    """A sharded layer's float32 product (K2a in train mode)."""
    if training:
        return DropoutMatmul.apply(y.contiguous(), w.contiguous(), base + layer, p, row0,
                                   col0)
    return F.linear(y, w).float()


class RNAEncoder(nn.Sequential):
    """``Dropout → Linear → ReLU → Dropout → Linear`` in ``dtype``
    (float32 output)."""

    def __init__(self, in_features: int = RNA_GENES,
                 hidden_dims: Sequence[int] = (4096, 2048), dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        layers: list[nn.Module] = []
        dims = [in_features, *hidden_dims]
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            if i:
                layers.append(nn.ReLU())
            layers += [nn.Dropout(dropout), nn.Linear(d_in, d_out)]
        super().__init__(*layers)
        self.out_features = dims[-1]
        self.dtype = dtype

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                seed: int | None = None) -> torch.Tensor:
        """Train mode: the layers' masks from ``seed`` (its ``base``), else
        from a seed drawn from ``generator``."""
        base = None
        if self.training:
            base = seed if seed is not None else draw_seed(generator)
        return dropout_linears(self, x, self.training, base, self.dtype).float()


class RNAOnlyModel(nn.Module):
    """Encoder + linear Cox head; ``extract`` returns the 2048-d embedding."""

    def __init__(self, encoder: RNAEncoder, out_features: int = 1):
        super().__init__()
        self.rna_mlp = encoder
        self.final_mlp = nn.Sequential(nn.Linear(encoder.out_features, out_features))

    def extract(self, rna: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        return self.rna_mlp(rna, generator)

    def from_embedding(self, emb: torch.Tensor) -> torch.Tensor:
        """Cox head over an externally computed embedding."""
        return self.final_mlp(emb)

    def forward(self, rna: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        return self.final_mlp(self.extract(rna, generator))
