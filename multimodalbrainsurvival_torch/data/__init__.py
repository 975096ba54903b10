"""Host-side data loading of the port."""

from multimodalbrainsurvival_torch.data.patches import PatchBagDataset
from multimodalbrainsurvival_torch.data.tables import RNATableDataset, TableDataset

__all__ = ["PatchBagDataset", "RNATableDataset", "TableDataset"]
