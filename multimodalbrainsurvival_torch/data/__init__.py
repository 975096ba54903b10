"""Host-side data loading of the port."""

from multimodalbrainsurvival_torch.data.patches import PatchBagDataset

__all__ = ["PatchBagDataset"]
