"""abcsmc_tpu_torch — the PyTorch/CUDA port of :mod:`abcsmc_tpu`.

ABC-SMC with PLS particle filtering on NVIDIA GPUs (Hopper, ``sm_90a``): one
card, or a particle mesh over cards and processes.
The module names mirror :mod:`abcsmc_tpu`, so each counterpart is easy to
find; the JAX package stays the numerical reference the port is held
against (``tests/test_torch_*.py``).

Idiom: plain functions on tensors, an explicit ``device`` and ``dtype`` on
every entry point, explicit ``torch.Generator`` objects (no global RNG), and
every random draw of a generation step passed in as a tensor
(:class:`abcsmc_tpu_torch.parallel.generation.StepDraws`).

The one hand-written kernel is the kernel-mixture weight denominator
(``csrc/mixture_logsumexp.cu``, wrapped by
:func:`abcsmc_tpu_torch.ops.kernels.mixture_logsumexp`).
"""

import torch as _torch

# Statistical linear algebra throughout (covariances, PLS Grams, score
# projections): every matmul is accuracy-critical, and TF32 keeps only about
# three decimal digits. Pin full FP32 for matmuls and cuDNN alike, mirroring
# the JAX package's HIGHEST matmul precision (abcsmc_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> _torch.device:
    """The torch device for ``device`` ("cuda", "cuda:0", "cpu" or a
    ``torch.device``). There is no implicit fallback: asking for CUDA where
    no CUDA device is visible raises instead of silently running on the CPU.
    """
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


# the counterparts of abcsmc_tpu's exports: Generation stands for
# ShardedGeneration (one device without a mesh, or a particle mesh)
from abcsmc_tpu_torch.config import ConfigError, SmcConfig, parse_config  # noqa: E402
from abcsmc_tpu_torch.engine import AbcSmc  # noqa: E402
from abcsmc_tpu_torch.models.metrics import Metric  # noqa: E402
from abcsmc_tpu_torch.models.parameters import (  # noqa: E402
    ContinuousUniformPrior,
    DiscreteUniformPrior,
    GaussianPrior,
    Parameter,
    ParameterSet,
    PosteriorParameter,
    PseudoParameter,
)
from abcsmc_tpu_torch.models.simulators import (  # noqa: E402
    BUILTIN_SIMULATORS,
    DeviceSimulator,
    ExecSimulator,
    PySimulator,
    SharedLibSimulator,
    Simulator,
    make_dice_simulator,
    make_gaussian_simulator,
    make_linear_gaussian_simulator,
    make_sir_simulator,
)
from abcsmc_tpu_torch.parallel import Generation, particle_mesh  # noqa: E402
from abcsmc_tpu_torch.storage import MemoryStorage, SQLiteStorage  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AbcSmc",
    "SmcConfig",
    "ConfigError",
    "parse_config",
    "Parameter",
    "GaussianPrior",
    "ContinuousUniformPrior",
    "DiscreteUniformPrior",
    "PseudoParameter",
    "PosteriorParameter",
    "ParameterSet",
    "Metric",
    "Simulator",
    "DeviceSimulator",
    "PySimulator",
    "ExecSimulator",
    "SharedLibSimulator",
    "BUILTIN_SIMULATORS",
    "make_dice_simulator",
    "make_gaussian_simulator",
    "make_sir_simulator",
    "make_linear_gaussian_simulator",
    "Generation",
    "particle_mesh",
    "MemoryStorage",
    "SQLiteStorage",
    "resolve_device",
]
