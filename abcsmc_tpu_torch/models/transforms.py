"""Fitting-space -> model-space parameter transforms on tensors (port of
:mod:`abcsmc_tpu.models.transforms`; the formula is documented there)."""

from __future__ import annotations

from typing import Sequence

import torch

from abcsmc_tpu_torch.config import ParameterSpec, TransformFunc


def _apply_func(func: TransformFunc, x):
    if func == TransformFunc.NONE:
        return x
    if func == TransformFunc.POW_10:
        return torch.pow(10.0, x)
    if func == TransformFunc.LOGISTIC:
        return 1.0 / (1.0 + torch.exp(-x))
    raise ValueError(f"unknown transform func {func}")


class ParameterTransform:
    """``to_model_space(theta[N, P]) -> upars[N, P]``
    (AbcSmc::_to_model_space, src/AbcSmc.cpp:432-447)."""

    def __init__(self, specs: Sequence[ParameterSpec]):
        self.specs = list(specs)
        self.has_any = any(s.untransform is not None for s in self.specs)

    def to_model_space(self, theta):
        if not self.has_any:
            return theta
        theta = torch.as_tensor(theta)
        cols = []
        for j, spec in enumerate(self.specs):
            u = spec.untransform
            x = theta[:, j]
            if u is None:
                cols.append(x)
                continue
            a = torch.zeros_like(x)
            for i in u.transformed_addend_idx:
                a = a + theta[:, i]
            b = torch.ones_like(x)
            for i in u.transformed_factor_idx:
                b = b * theta[:, i]
            c = torch.zeros_like(x)
            for i in u.untransformed_addend_idx:
                c = c + theta[:, i]
            d = torch.ones_like(x)
            for i in u.untransformed_factor_idx:
                d = d * theta[:, i]
            val = (_apply_func(u.func, (x + a) * b) + c) * d
            val = (u.rescale_max - u.rescale_min) * val + u.rescale_min
            cols.append(val)
        return torch.stack(cols, dim=1)
