"""Error types for abcsmc_tpu_torch.

The C++ reference signals configuration / runtime errors by ``exit()``-ing with
distinct negative codes scattered through ``src/AbcSmc.cpp`` (e.g. -201 .. -214).
A library should raise, not exit; we preserve the codes as machine-checkable
attributes so CLI wrappers can reproduce the reference exit behavior exactly.
"""

from __future__ import annotations


class AbcError(Exception):
    """Base class for all abcsmc_tpu_torch errors.

    ``code`` mirrors the exit codes used by the reference implementation
    (``src/AbcSmc.cpp``), where one exists for the condition.
    """

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        self.code = code


class ConfigError(AbcError):
    """Invalid configuration (reference: parse_config and friends)."""


class StorageError(AbcError):
    """Run-store / database errors (reference: sqdb exceptions, table checks)."""


class SimulatorError(AbcError):
    """Simulator invocation/metric-count errors (reference: exit(-211) at
    src/AbcSmc.cpp:1014, metric-count check at src/AbcSmc.cpp:683-687)."""
