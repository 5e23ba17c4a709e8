"""Observed summary-statistic metadata.

Mirror of the reference Metric/TMetric (include/AbcSmc/Metric.h:9-35): a named
observed summary stat with INT/FLOAT typing and an observed value.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from abcsmc_tpu_torch.config import MetricSpec, NumType


@dataclass(frozen=True)
class Metric:
    name: str
    short_name: str
    num_type: NumType
    value: float

    @property
    def is_integral(self) -> bool:
        return self.num_type == NumType.INT

    @classmethod
    def from_spec(cls, spec: MetricSpec) -> "Metric":
        return cls(spec.name, spec.short_name, spec.num_type, spec.value)


def observed_vector(metrics: list[Metric]) -> np.ndarray:
    """The observed-metrics row (AbcSmc::_met_vals, AbcSmc.h:75-80)."""
    return np.array([m.value for m in metrics], dtype=np.float64)
