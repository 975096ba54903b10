"""Models of the port: ResNet encoders, MIL aggregators and heads."""

from multimodalbrainsurvival_torch.models.aggregators import (
    IdentityAggregator,
    TanhAttention,
    make_aggregator,
)
from multimodalbrainsurvival_torch.models.mil import (
    AggregationModel,
    AggregationProjectModel,
    masked_bag_mean,
)
from multimodalbrainsurvival_torch.models.resnet import RESNET_CONSTRUCTORS

__all__ = [
    "AggregationModel",
    "AggregationProjectModel",
    "IdentityAggregator",
    "RESNET_CONSTRUCTORS",
    "TanhAttention",
    "make_aggregator",
    "masked_bag_mean",
]
