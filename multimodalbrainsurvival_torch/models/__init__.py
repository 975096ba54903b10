"""Models of the port: ResNet encoders (and the tanh projection on them),
MIL aggregators and heads, the RNA MLP, the fusion models."""

from multimodalbrainsurvival_torch.models.aggregators import (
    IdentityAggregator,
    TanhAttention,
    TransformerAggregator,
    make_aggregator,
)
from multimodalbrainsurvival_torch.models.fusion import (
    BagHistopathologyRNAModel,
    EarlyFusionMLP,
    PatchHistopathologyRNAModel,
)
from multimodalbrainsurvival_torch.models.mil import (
    AggregationModel,
    AggregationProjectModel,
    masked_bag_mean,
)
from multimodalbrainsurvival_torch.models.resnet import RESNET_CONSTRUCTORS, ResNetProject
from multimodalbrainsurvival_torch.models.rna import RNAEncoder, RNAOnlyModel

__all__ = [
    "AggregationModel",
    "AggregationProjectModel",
    "BagHistopathologyRNAModel",
    "EarlyFusionMLP",
    "IdentityAggregator",
    "PatchHistopathologyRNAModel",
    "RESNET_CONSTRUCTORS",
    "RNAEncoder",
    "RNAOnlyModel",
    "ResNetProject",
    "TanhAttention",
    "TransformerAggregator",
    "make_aggregator",
    "masked_bag_mean",
]
