"""Parameters, metrics, transforms and device simulators on tensors."""

from abcsmc_tpu_torch.models.metrics import Metric
from abcsmc_tpu_torch.models.parameters import (
    ContinuousUniformPrior,
    DiscreteUniformPrior,
    GaussianPrior,
    Parameter,
    ParameterSet,
    PosteriorParameter,
    PseudoParameter,
)
from abcsmc_tpu_torch.models.transforms import ParameterTransform

__all__ = [
    "Parameter",
    "GaussianPrior",
    "ContinuousUniformPrior",
    "DiscreteUniformPrior",
    "PseudoParameter",
    "PosteriorParameter",
    "ParameterSet",
    "Metric",
    "ParameterTransform",
]
