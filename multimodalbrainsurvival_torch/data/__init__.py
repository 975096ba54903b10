"""Host-side data loading of the port."""

from multimodalbrainsurvival_torch.data.patches import (
    PatchBagDataset,
    PatchBagRNADataset,
    PatchRNADataset,
)
from multimodalbrainsurvival_torch.data.tables import (
    FeatureTableDataset,
    RNATableDataset,
    TableDataset,
)

__all__ = ["FeatureTableDataset", "PatchBagDataset", "PatchBagRNADataset",
           "PatchRNADataset", "RNATableDataset", "TableDataset"]
