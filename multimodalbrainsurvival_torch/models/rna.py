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
caller's ``torch.Generator``; that is the only way train mode reaches the
Linear layers. In eval mode each Linear is ``F.linear``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodalbrainsurvival_torch.kernels.dropout_matmul import DropoutMatmul

#: the reference's gene count (``1_GeneExpress_train.py:247``)
RNA_GENES = 12778


class RNAEncoder(nn.Sequential):
    """``Dropout → Linear → ReLU → Dropout → Linear`` (float32)."""

    def __init__(self, in_features: int = RNA_GENES,
                 hidden_dims: Sequence[int] = (4096, 2048), dropout: float = 0.5):
        layers: list[nn.Module] = []
        dims = [in_features, *hidden_dims]
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            if i:
                layers.append(nn.ReLU())
            layers += [nn.Dropout(dropout), nn.Linear(d_in, d_out)]
        super().__init__(*layers)
        self.out_features = dims[-1]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        y = x.float()
        if self.training:
            # distinct seeds per layer: equal seeds would give equal masks
            # on the columns the layers share
            base = int(torch.randint(0, 2**31, (), generator=generator))
        p, layer = 0.0, 0
        for m in self:
            if isinstance(m, nn.Dropout):
                p = m.p
            elif isinstance(m, nn.Linear):
                if self.training:
                    y = DropoutMatmul.apply(y, m.weight, base + layer, p) + m.bias
                else:
                    y = F.linear(y, m.weight, m.bias)
                p, layer = 0.0, layer + 1
            else:
                y = m(y)
        return y


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
