"""The generation step, on one device or over a particle mesh."""

from abcsmc_tpu_torch.parallel.mesh import (
    ParticleMesh,
    fetch_rows_global,
    initialize_distributed,
    particle_mesh,
)
from abcsmc_tpu_torch.parallel.generation import (
    Generation,
    GenerationResult,
    StepDraws,
    sharded_simulate,
)

__all__ = ["particle_mesh", "ParticleMesh", "initialize_distributed",
           "fetch_rows_global", "Generation", "GenerationResult", "StepDraws",
           "sharded_simulate"]
