"""The single-device generation step."""

from abcsmc_tpu_torch.parallel.generation import (
    Generation,
    GenerationResult,
    StepDraws,
)

__all__ = ["Generation", "GenerationResult", "StepDraws"]
