"""Configuration schema and parsing.

Accepts the reference's JSON configuration files verbatim. Schema (from
``src/AbcSmc.cpp:337-430`` [parse_config],
``:54-137`` [parse_iterations], ``:139-154`` [parse_metric],
``:156-211`` [parse_transform], ``:213-273`` [parse_parameter]):

Top-level keys:
  ``smc_iterations``               int (fitting mode; default max(len sizes))
  ``num_samples``                  int or [int]   (scalar-or-array; last value extends)
  ``predictive_prior_fraction``    float or [float] in (0,1]  (XOR with _size)
  ``predictive_prior_size``        int or [int]               (XOR with _fraction)
  ``pls_training_fraction``        float in (0,1), default 0.5
  ``noise``                        "INDEPENDENT" (default) | "MULTIVARIATE"
  ``parameters``                   [ {name, short_name?, dist_type, num_type,
                                      par1?, par2?, step?, vals?, untransform?} ]
  ``metrics``                      [ {name, short_name?, num_type, value} ]
  ``executable`` | ``shared``      external simulator binding
  ``database_filename``            run store path
  ``posterior_database_filename``  source DB for POSTERIOR parameters
  ``retain_posterior_rank``        bool, default false
  ``resume_directory``             parsed-but-unused in the reference; kept for parity

Extensions over the reference (all optional, defaulted to reference behavior):
  ``filter``       "PLS" (default) | "SIMPLE"  — the reference only exposes this via
                   the C++ API (set_filtering_type, include/AbcSmc/AbcSmc.h:104)
  ``simulator``    name of a built-in device simulator (e.g. "dice", "sir")
  ``max_retries``  bound on truncated-sampling rejection loops (default 1000,
                   matching Priors.h:19-33 MAX_ATTEMPTS)
  ``box_cox``      skewness-minimizing Box-Cox transform of metrics before PLS
                   ranking (the reference's TODO at src/AbcUtil.cpp:430)
  ``nrmse_tolerance``  stop the run() / run_device() loops early once the
                   posterior metric means' NRMSE drops below this (0 = off)
  ``pls_optimal_method``  "vdv" (default: van der Voet randomization test,
                   the rule upstream tjhladish/PLS uses) or "tolerance"
                   (fewest components within 10% of min PRESS); see
                   docs/PARITY.md for the numerical comparison
  ``resample_method``  "multinomial" (default: iid categorical, matching
                   gsl_ran_discrete) or "systematic" (single-offset
                   stratified resampling - strictly lower variance;
                   Kitagawa 1996)
  ``weight_precision``  MXU dot precision of the device weight kernel:
                   "high" (default: lane-packed 3-way split-bf16, 7.6e-6
                   nats vs full f32 at 4.6x the speed for <= 19 params),
                   "highest" (full f32), or "default" (single bf16 pass,
                   ~4e-2 nats); see docs/DESIGN.md "Where the rooflines
                   are"
  ``row_block``    device-path row chunking for very large populations:
                   unset = auto (O(N)-row passes stream through scan blocks
                   once a shard holds >= 2^25 rows, keeping the [N, M]
                   z-score and [N, A] score buffers out of HBM), an int > 0
                   forces that block size, 0 disables
  ``propose_split``  run the proposal (resample + perturb) as its own
                   sharded program: unset = auto (splits once a shard's
                   population or proposal slice reaches 2^26 rows, so
                   rank-phase and propose-phase temporaries never coexist
                   in HBM - the single-chip 100M path), true/false force;
                   draws are bit-identical to the fused step's
  ``topk_two_stage``  global top-K strategy on the mesh: unset = auto
                   (two-stage - distance gather + mesh-size-independent
                   survivor-row psum - once the candidate gather would
                   exceed 16 MiB/device on a >1-device mesh), true/false
                   force; results are bit-identical either way
                   (docs/SCALING.md)
  ``device_dispatch``  how run_device launches the per-set programs:
                   "auto" (default: fuse the whole chain into one program
                   per size transition - run_scan/run_chain - whenever the
                   run is fresh and the stacked-history HBM bill is
                   modest), "fused" (fuse regardless of the HBM-bill
                   heuristic; still requires a fresh, non-split run), or
                   "sequential" (one program dispatch per SMC set - the
                   debugging/measurement baseline the fused paths are
                   pinned against). Results are identical either way;
                   only dispatch count changes
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

from abcsmc_tpu_torch.errors import ConfigError


class DistType(str, Enum):
    UNIFORM = "UNIFORM"
    NORMAL = "NORMAL"
    PSEUDO = "PSEUDO"
    POSTERIOR = "POSTERIOR"


class NumType(str, Enum):
    INT = "INT"
    FLOAT = "FLOAT"


class NoiseType(str, Enum):
    INDEPENDENT = "INDEPENDENT"
    MULTIVARIATE = "MULTIVARIATE"


class FilterType(str, Enum):
    PLS = "PLS"
    SIMPLE = "SIMPLE"


class TransformFunc(str, Enum):
    NONE = "NONE"
    POW_10 = "POW_10"
    LOGISTIC = "LOGISTIC"


@dataclass(frozen=True)
class UntransformSpec:
    """Fitting-space -> model-space transform spec.

    Model-space value x' = rescale(u((x + a) * b) + c) * d) where a/b/c/d are
    sums/products over *other* parameters' fitting-space values, per
    ``include/AbcSmc/ParXform.h:11-54``; rescale(v) = (max-min)*v + min
    (``ParXform.h:64-68``).
    """

    func: TransformFunc
    rescale_min: float = 0.0
    rescale_max: float = 1.0
    # index lists into the parameter vector (cross-parameter modifiers)
    transformed_addend_idx: tuple[int, ...] = ()
    transformed_factor_idx: tuple[int, ...] = ()
    untransformed_addend_idx: tuple[int, ...] = ()
    untransformed_factor_idx: tuple[int, ...] = ()


@dataclass(frozen=True)
class ParameterSpec:
    name: str
    short_name: str
    dist_type: DistType
    num_type: NumType
    par1: float = 0.0
    par2: float = 0.0
    # PSEUDO grid: explicit values (from "vals" or par1..par2 by step)
    values: tuple[float, ...] = ()
    # POSTERIOR state size (par2 - par1 + 1)
    posterior_size: int = 0
    untransform: UntransformSpec | None = None

    @property
    def state_size(self) -> int:
        """Grid size for indexed (PSEUDO/POSTERIOR) parameters; 0 = not indexed."""
        if self.dist_type == DistType.PSEUDO:
            return len(self.values)
        if self.dist_type == DistType.POSTERIOR:
            return self.posterior_size
        return 0

    @property
    def is_posterior(self) -> bool:
        return self.dist_type == DistType.POSTERIOR


@dataclass(frozen=True)
class MetricSpec:
    name: str
    short_name: str
    num_type: NumType
    value: float


@dataclass
class SmcConfig:
    parameters: list[ParameterSpec]
    metrics: list[MetricSpec]
    num_smc_sets: int
    smc_set_sizes: list[int]
    predictive_prior_sizes: list[int]
    pls_training_fraction: float = 0.5
    noise: NoiseType = NoiseType.INDEPENDENT
    filter: FilterType = FilterType.PLS
    database_filename: str = ""
    posterior_database_filename: str = ""
    executable: str = ""
    shared: str = ""
    simulator_name: str = ""
    retain_posterior_rank: bool = False
    resume_directory: str = ""
    max_retries: int = 1000
    box_cox: bool = False
    nrmse_tolerance: float = 0.0
    pls_optimal_method: str = "vdv"
    resample_method: str = "multinomial"
    weight_precision: str = "high"
    row_block: int | None = None
    propose_split: bool | None = None
    topk_two_stage: bool | None = None
    device_dispatch: str = "auto"
    projection_mode: bool = False
    raw: dict = field(default_factory=dict)

    # --- reference accessors (include/AbcSmc/AbcSmc.h:44-52): scalar-or-array with
    #     last-value extension semantics ---
    def smc_size_at(self, set_num: int) -> int:
        if set_num >= self.num_smc_sets:
            raise ConfigError(f"set_num {set_num} out of range", code=None)
        if set_num < len(self.smc_set_sizes):
            return self.smc_set_sizes[set_num]
        return self.smc_set_sizes[-1]

    def pred_prior_size_at(self, set_num: int) -> int:
        if set_num >= self.num_smc_sets:
            raise ConfigError(f"set_num {set_num} out of range", code=None)
        if set_num < len(self.predictive_prior_sizes):
            return self.predictive_prior_sizes[set_num]
        return self.predictive_prior_sizes[-1]

    @property
    def npar(self) -> int:
        return len(self.parameters)

    @property
    def nmet(self) -> int:
        return len(self.metrics)

    @property
    def met_vals(self) -> list[float]:
        return [m.value for m in self.metrics]

    @property
    def has_untransforms(self) -> bool:
        return any(p.untransform is not None for p in self.parameters)


def _as_list(val: Any) -> list:
    """Scalar-or-array JSON semantics (src/AbcSmc.cpp:43-52)."""
    if isinstance(val, list):
        return list(val)
    return [val]


# -- typed accessors -----------------------------------------------------
# The reference reads fields through jsoncpp's asDouble()/asInt()/asString(),
# which throw Json::LogicError on a type mismatch and abort the run; the
# library analog is a coded ConfigError. These guarantee no raw KeyError/
# TypeError/ValueError ever escapes the parser (pinned by
# tests/test_config_fuzz.py).

def _cfg_req(obj: Any, key: str, ctx: str, code: int | None = 1) -> Any:
    if not isinstance(obj, dict) or key not in obj:
        raise ConfigError(f"missing required key '{key}' in {ctx}", code=code)
    return obj[key]


def _cfg_float(val: Any, ctx: str, code: int | None = 1) -> float:
    # bool/str rejected explicitly (jsoncpp asDouble would throw); numpy
    # scalars accepted (dict-input configs built programmatically)
    if not isinstance(val, (bool, str)):
        try:
            return float(val)
        except (TypeError, ValueError):
            pass
    raise ConfigError(f"{ctx} must be a number, got {val!r}", code=code)


def _cfg_int(val: Any, ctx: str, code: int | None = 1) -> int:
    if not isinstance(val, (bool, str)):
        try:
            out = int(val)
            # range-bound like jsoncpp's asInt/asInt64 (throws out-of-range):
            # a "num_samples": 1e30 must be a config error, not an allocation
            # failure twenty frames later
            if out == val and abs(out) < (1 << 62):
                return out
        except (TypeError, ValueError, OverflowError):
            pass
    raise ConfigError(f"{ctx} must be an integer, got {val!r}", code=code)


def _cfg_str(val: Any, ctx: str, code: int | None = 1) -> str:
    if not isinstance(val, str):
        raise ConfigError(f"{ctx} must be a string, got {val!r}", code=code)
    return val


def _parse_parameter(mpar: dict) -> ParameterSpec:
    """Parse one parameter object (src/AbcSmc.cpp:213-273)."""
    name = _cfg_str(_cfg_req(mpar, "name", "parameter"), "parameter name")
    short_name = _cfg_str(
        mpar.get("short_name", name), f"parameter '{name}' short_name"
    )
    ptype_str = mpar.get("dist_type", "")
    ntype_str = mpar.get("num_type", "")

    if ntype_str not in ("INT", "FLOAT"):
        raise ConfigError(
            f"Unknown parameter numeric type: {ntype_str}.", code=-206
        )
    num_type = NumType(ntype_str)

    ctx = f"parameter '{name}'"

    def fpar(key):
        v = _cfg_float(_cfg_req(mpar, key, ctx), f"{ctx} {key}")
        # jsoncpp (strict JSON) cannot represent NaN/Infinity, so the
        # reference can never reach a non-finite prior bound; Python's
        # json.load accepts them - reject to match
        if not math.isfinite(v):
            raise ConfigError(f"{ctx} {key} must be finite, got {v!r}", code=1)
        return v

    if ptype_str == "UNIFORM":
        return ParameterSpec(
            name=name, short_name=short_name, dist_type=DistType.UNIFORM,
            num_type=num_type,
            par1=fpar("par1"), par2=fpar("par2"),
        )
    if ptype_str in ("NORMAL", "GAUSSIAN"):
        if ntype_str == "INT":
            raise ConfigError(
                f"Parameter numeric INT not supported for parameter type {ptype_str}.",
                code=-206,
            )
        return ParameterSpec(
            name=name, short_name=short_name, dist_type=DistType.NORMAL,
            num_type=num_type,
            par1=fpar("par1"), par2=fpar("par2"),
        )
    if ptype_str == "PSEUDO":
        if "vals" in mpar:
            states = tuple(
                _cfg_float(v, f"{ctx} vals entry")
                for v in _as_list(mpar["vals"])
            )
            if not states or not all(map(math.isfinite, states)):
                raise ConfigError(
                    f"{ctx}: PSEUDO vals must be a non-empty list of finite "
                    f"numbers",
                    code=1,
                )
        else:
            smax = fpar("par2")
            step = _cfg_float(mpar.get("step", 1.0), f"{ctx} step")
            s = fpar("par1")
            # a non-finite or negative step makes the reference's inclusive
            # grid loop (src/AbcSmc.cpp:252-258) never terminate when
            # par1 <= par2; reject instead (deliberate deviation)
            if not all(map(math.isfinite, (s, smax, step))) or step < 0:
                raise ConfigError(
                    f"{ctx}: PSEUDO grid par1/par2/step must be finite with "
                    f"step >= 0 (got par1={s!r}, par2={smax!r}, step={step!r})",
                    code=1,
                )
            states_l: list[float] = []
            if step != 0:
                # inclusive grid with epsilon slack (src/AbcSmc.cpp:252-258)
                eps = 0.0001
                while s <= smax + eps * step:
                    if len(states_l) >= (1 << 24):
                        raise ConfigError(
                            f"{ctx}: PSEUDO grid exceeds 2^24 points", code=1
                        )
                    states_l.append(s)
                    s += step
            else:
                states_l.append(s)
            if not states_l:
                # par1 > par2: the reference's loop body never runs and the
                # parameter would have zero states - a config error here, not
                # a downstream shape crash
                raise ConfigError(
                    f"{ctx}: PSEUDO grid is empty (par1 > par2)", code=1
                )
            states = tuple(states_l)
        return ParameterSpec(
            name=name, short_name=short_name, dist_type=DistType.PSEUDO,
            num_type=num_type, values=states,
        )
    if ptype_str == "POSTERIOR":
        size = (
            _cfg_int(_cfg_req(mpar, "par2", ctx), f"{ctx} par2")
            - _cfg_int(_cfg_req(mpar, "par1", ctx), f"{ctx} par1") + 1
        )
        if size < 1:
            raise ConfigError(
                f"{ctx}: POSTERIOR requires par1 <= par2 (index range), got "
                f"size {size}",
                code=1,
            )
        return ParameterSpec(
            name=name, short_name=short_name, dist_type=DistType.POSTERIOR,
            num_type=num_type, posterior_size=size,
        )
    raise ConfigError(
        f"Unknown parameter distribution type: {ptype_str}.", code=-205
    )


def _parse_untransform(
    mparu: Any, par_name_idx: dict[str, int]
) -> UntransformSpec:
    """Parse an 'untransform' entry (src/AbcSmc.cpp:156-211)."""
    if isinstance(mparu, str):
        if mparu not in ("NONE", "POW_10", "LOGISTIC"):
            raise ConfigError(
                f"Unknown parameter transformation type: {mparu}.", code=-206
            )
        return UntransformSpec(func=TransformFunc(mparu))
    if isinstance(mparu, dict):
        ttype_str = mparu.get("type", "")
        if ttype_str != "LOGISTIC":
            raise ConfigError(
                "Only type: LOGISTIC is currently supported for untransformation "
                "objects. (NONE and POW_10 supported as untransformation strings.)",
                code=-207,
            )
        idx_lists: dict[str, tuple[int, ...]] = {}
        for key in (
            "transformed_addend", "transformed_factor",
            "untransformed_addend", "untransformed_factor",
        ):
            names = [
                _cfg_str(n, f"untransform {key} entry", code=-208)
                for n in _as_list(mparu.get(key, []))
            ]
            try:
                idx_lists[key] = tuple(par_name_idx[n] for n in names)
            except KeyError as e:
                raise ConfigError(
                    f"untransform {key} references unknown parameter {e}", code=-208
                )
        return UntransformSpec(
            func=TransformFunc.LOGISTIC,
            rescale_min=_cfg_float(
                _cfg_req(mparu, "min", "untransform", code=-208),
                "untransform min", code=-208,
            ),
            rescale_max=_cfg_float(
                _cfg_req(mparu, "max", "untransform", code=-208),
                "untransform max", code=-208,
            ),
            transformed_addend_idx=idx_lists["transformed_addend"],
            transformed_factor_idx=idx_lists["transformed_factor"],
            untransformed_addend_idx=idx_lists["untransformed_addend"],
            untransformed_factor_idx=idx_lists["untransformed_factor"],
        )
    raise ConfigError(
        "Unsupported JSON data type associated with 'untransform' parameter key.",
        code=-208,
    )


def _parse_metric(mmet: dict) -> MetricSpec:
    """Parse one metric object (src/AbcSmc.cpp:139-154)."""
    name = _cfg_str(_cfg_req(mmet, "name", "metric"), "metric name")
    short_name = _cfg_str(
        mmet.get("short_name", name), f"metric '{name}' short_name"
    )
    ntype_str = mmet.get("num_type", "")
    if ntype_str not in ("INT", "FLOAT"):
        raise ConfigError(f"Unknown metric numeric type: {ntype_str}.", code=-209)
    return MetricSpec(
        name=name,
        short_name=short_name,
        num_type=NumType(ntype_str),
        value=(
            _cfg_float(mmet["value"], f"metric '{name}' value")
            if "value" in mmet else math.nan
        ),
    )


def _parse_iterations(
    par: dict, pseudosize: int
) -> tuple[int, float, list[int], list[int], bool]:
    """Iteration / set-size / predictive-prior-size semantics
    (src/AbcSmc.cpp:54-137).

    Returns (iterations, training_frac, set_sizes, pred_prior_sizes, projection).
    """
    if pseudosize != 0:
        # projection mode: all parameters are PSEUDO/POSTERIOR
        if _cfg_int(par.get("smc_iterations", 1), "smc_iterations") != 1:
            raise ConfigError(
                "Cannot use smc_iterations > 1 with ONLY PSEUDO or POSTERIOR "
                "parameters.",
                code=-202,
            )
        if "num_samples" in par:
            ns_list = _as_list(par["num_samples"])
            if not ns_list:
                raise ConfigError("num_samples must not be empty", code=1)
            checksize = _cfg_int(ns_list[0], "num_samples")
            if checksize != pseudosize:
                raise ConfigError(
                    f"`num_samples` ({checksize}) does not match imputed "
                    f"combinations of PSEUDO and/or POSTERIOR parameters "
                    f"({pseudosize}).",
                    code=-201,
                )
        return 1, 0.5, [pseudosize], [], True

    # fitting mode
    has_frac = "predictive_prior_fraction" in par
    has_size = "predictive_prior_size" in par
    if has_frac == has_size:
        raise ConfigError(
            "exactly one of `predictive_prior_fraction` or "
            "`predictive_prior_size` must be specified in configuration file.",
            code=1,
        )

    training_frac = _cfg_float(
        par.get("pls_training_fraction", 0.5), "pls_training_fraction"
    )
    if not (0.0 < training_frac < 1.0):
        raise ConfigError("pls_training_fraction must be in (0, 1).", code=1)

    set_sizes = [
        _cfg_int(v, "num_samples")
        for v in _as_list(_cfg_req(par, "num_samples", "configuration"))
    ]
    if not set_sizes or any(s < 1 for s in set_sizes):
        raise ConfigError(
            "num_samples must be one or more positive integers", code=1
        )

    if has_frac:
        ppfs = [
            _cfg_float(v, "predictive_prior_fraction")
            for v in _as_list(par["predictive_prior_fraction"])
        ]
        if not ppfs:
            raise ConfigError(
                "predictive_prior_fraction must not be empty", code=1
            )
        if not all(0.0 < f <= 1.0 for f in ppfs):
            raise ConfigError(
                "`predictive_prior_fraction`s must be in (0, 1]", code=1
            )
        max_set = max(len(ppfs), len(set_sizes))
        ppfs_ext = ppfs + [ppfs[-1]] * (max_set - len(ppfs))
        sizes_ext = set_sizes + [set_sizes[-1]] * (max_set - len(set_sizes))
        # round-half-away-from-zero, matching C round() (src/AbcSmc.cpp:111)
        pred_prior_sizes = [
            int(math.floor(f * s + 0.5)) for f, s in zip(ppfs_ext, sizes_ext)
        ]
        if any(p < 1 for p in pred_prior_sizes):
            # e.g. fraction 0.1 of 4 samples rounds to 0 survivors - the
            # explicit-size path rejects this, so must the fraction path
            raise ConfigError(
                "predictive_prior_fraction rounds to zero survivors for at "
                "least one set; increase the fraction or num_samples",
                code=1,
            )
    else:
        pred_prior_sizes = [
            _cfg_int(v, "predictive_prior_size")
            for v in _as_list(par["predictive_prior_size"])
        ]
        if not pred_prior_sizes or any(p < 1 for p in pred_prior_sizes):
            raise ConfigError(
                "predictive_prior_size must be one or more positive integers",
                code=1,
            )
        max_set = max(len(pred_prior_sizes), len(set_sizes))
        for i in range(max_set):
            pps = pred_prior_sizes[i] if i < len(pred_prior_sizes) else pred_prior_sizes[-1]
            ss = set_sizes[i] if i < len(set_sizes) else set_sizes[-1]
            if pps > ss:
                raise ConfigError(
                    f"requested predictive prior size > SMC set size at: {i}",
                    code=1,
                )

    iterations = _cfg_int(
        par.get("smc_iterations", max(len(set_sizes), len(pred_prior_sizes))),
        "smc_iterations",
    )
    if iterations < 1:
        raise ConfigError("smc_iterations must be a positive integer", code=1)
    return iterations, training_frac, set_sizes, pred_prior_sizes, False


def parse_config(source: str | os.PathLike | dict) -> SmcConfig:
    """Parse a reference-compatible JSON config file (or pre-loaded dict).

    Mirrors AbcSmc::parse_config (src/AbcSmc.cpp:337-430).
    """
    if isinstance(source, dict):
        par = source
    elif isinstance(source, (str, os.PathLike)):
        if not os.path.exists(source):
            raise ConfigError(f"File does not exist: {source}", code=1)
        with open(source) as f:
            try:
                par = json.load(f)
            except json.JSONDecodeError as e:
                raise ConfigError(f"Failed to parse configuration: {e}", code=1)
        if not isinstance(par, dict):
            raise ConfigError(
                f"configuration document must be a JSON object, got "
                f"{type(par).__name__}",
                code=1,
            )
    else:
        raise ConfigError(
            f"configuration must be a filename or a JSON object, got "
            f"{type(source).__name__}",
            code=1,
        )

    retain_posterior_rank = bool(par.get("retain_posterior_rank", False))

    model_par = par.get("parameters", [])
    if not isinstance(model_par, list) or not all(
        isinstance(m, dict) for m in model_par
    ):
        raise ConfigError(
            "'parameters' must be an array of JSON objects", code=1
        )
    par_name_idx: dict[str, int] = {}
    for i, mpar in enumerate(model_par):
        nm = _cfg_str(_cfg_req(mpar, "name", "parameter"), "parameter name")
        if nm in par_name_idx:
            raise ConfigError(f"duplicate parameter name: {nm}", code=None)
        par_name_idx[nm] = i

    parameters: list[ParameterSpec] = []
    pseudosize = 1
    posterior_size = 0
    any_posterior = False
    any_prior = False
    for mpar in model_par:
        spec = _parse_parameter(mpar)
        if spec.is_posterior:
            if posterior_size == 0:
                posterior_size = spec.state_size
                any_posterior = True
            elif spec.state_size != posterior_size:
                raise ConfigError(
                    "all POSTERIOR parameters must have the same state size",
                    code=None,
                )
        else:
            if spec.state_size == 0:
                any_prior = True
            pseudosize *= max(spec.state_size, 1)
        if "untransform" in mpar:
            spec = ParameterSpec(
                **{
                    **spec.__dict__,
                    "untransform": _parse_untransform(
                        mpar["untransform"], par_name_idx
                    ),
                }
            )
        parameters.append(spec)

    # pseudosize != 0 <=> all parameters are PSEUDO/POSTERIOR => projection mode
    # (src/AbcSmc.cpp:354-396: pseudosize is the product of non-posterior state
    # sizes; a prior parameter contributes state_size 0, zeroing the product)
    if any_prior:
        pseudosize = 0
    if any_posterior and pseudosize != 0:
        pseudosize *= posterior_size

    model_met = par.get("metrics", [])
    if not isinstance(model_met, list) or not all(
        isinstance(m, dict) for m in model_met
    ):
        raise ConfigError("'metrics' must be an array of JSON objects", code=1)
    metrics = [_parse_metric(m) for m in model_met]

    (
        num_smc_sets, training_frac, set_sizes, pred_prior_sizes, projection
    ) = _parse_iterations(par, pseudosize)

    if not projection:
        # fitting mode ranks particles by distance to the observed vector: a
        # metric without a "value" would NaN-poison every distance and make
        # the 'survivors' the first K rows in insertion order, silently.
        # (The reference's jsoncpp null.asDouble() would quietly use 0.0 -
        # src/AbcSmc.cpp:142 - equally wrong statistically; we fail fast
        # instead. Deliberate deviation, docs/PARITY.md. Projection configs
        # legitimately omit values: nothing is ranked there.)
        missing = [m.name for m in metrics if math.isnan(m.value)]
        if missing:
            raise ConfigError(
                "metric(s) missing an observed 'value' in a fitting-mode "
                f"configuration: {', '.join(missing)}.",
                code=1,
            )

    if any_posterior:
        if "posterior_database_filename" not in par:
            raise ConfigError(
                "Parameter specified as type POSTERIOR, without previously "
                "specifying a posterior_database_filename.",
                code=-204,
            )
        if num_smc_sets > 1:
            raise ConfigError(
                "Cannot use posterior parameters with multiple SMC sets.",
                code=-203,
            )

    noise_str = par.get("noise", "INDEPENDENT")
    if noise_str not in ("INDEPENDENT", "MULTIVARIATE"):
        raise ConfigError(
            f"Unknown parameter noise type specified: {noise_str}.", code=-210
        )

    filter_str = par.get("filter", "PLS")
    if filter_str not in ("PLS", "SIMPLE"):
        raise ConfigError(f"Unknown filter type: {filter_str}", code=None)

    return SmcConfig(
        parameters=parameters,
        metrics=metrics,
        num_smc_sets=num_smc_sets,
        smc_set_sizes=set_sizes,
        predictive_prior_sizes=pred_prior_sizes,
        pls_training_fraction=training_frac,
        noise=NoiseType(noise_str),
        filter=FilterType(filter_str),
        database_filename=_cfg_str(
            par.get("database_filename", ""), "database_filename"
        ),
        posterior_database_filename=_cfg_str(
            par.get("posterior_database_filename", ""),
            "posterior_database_filename",
        ),
        executable=_cfg_str(par.get("executable", ""), "executable"),
        shared=_cfg_str(par.get("shared", ""), "shared"),
        simulator_name=_cfg_str(par.get("simulator", ""), "simulator"),
        retain_posterior_rank=retain_posterior_rank,
        resume_directory=_cfg_str(
            par.get("resume_directory", ""), "resume_directory"
        ),
        max_retries=_cfg_int(par.get("max_retries", 1000), "max_retries"),
        box_cox=bool(par.get("box_cox", False)),
        nrmse_tolerance=_cfg_float(
            par.get("nrmse_tolerance", 0.0), "nrmse_tolerance"
        ),
        pls_optimal_method=_parse_pls_optimal_method(par),
        resample_method=_parse_resample_method(par),
        weight_precision=_parse_weight_precision(par),
        row_block=_parse_row_block(par),
        propose_split=_parse_propose_split(par),
        topk_two_stage=_parse_tristate_bool(par, "topk_two_stage"),
        device_dispatch=_parse_device_dispatch(par),
        projection_mode=projection,
        raw=par,
    )


def _parse_pls_optimal_method(par: dict) -> str:
    method = par.get("pls_optimal_method", "vdv")
    if method not in ("vdv", "tolerance"):
        # without this, a typo silently fell through the `== "vdv"` branches
        # (parallel/generation.py, ops/ranking.py) to tolerance selection
        raise ConfigError(
            f"pls_optimal_method must be 'vdv' or 'tolerance', got {method!r}",
            code=1,
        )
    return method


def _parse_resample_method(par: dict) -> str:
    method = str(par.get("resample_method", "multinomial"))
    if method not in ("multinomial", "systematic"):
        raise ConfigError(
            f"resample_method must be 'multinomial' or 'systematic', "
            f"got {method!r}",
            code=1,
        )
    return method


def _parse_propose_split(par: dict):
    return _parse_tristate_bool(par, "propose_split")


def _parse_device_dispatch(par: dict) -> str:
    v = str(par.get("device_dispatch", "auto"))
    if v not in ("auto", "fused", "sequential"):
        raise ConfigError(
            f"device_dispatch must be 'auto', 'fused', or 'sequential', "
            f"got {v!r}",
            code=1,
        )
    return v


def _parse_tristate_bool(par: dict, key: str):
    v = par.get(key, None)
    if v is None:
        return None
    if not isinstance(v, bool):
        raise ConfigError(f"{key} must be a boolean, got {v!r}", code=1)
    return v


def _parse_row_block(par: dict):
    rb = par.get("row_block", None)
    if rb is None:
        return None
    try:
        rb_int = int(rb)
    except (TypeError, ValueError):
        rb_int = -1
    # bool is an int subclass: "row_block": true would otherwise silently
    # parse as block size 1 (a pathological one-row-per-scan-step program)
    if (
        rb_int < 0
        or isinstance(rb, bool)
        or not isinstance(rb, (int, float))
        or rb_int != rb
    ):
        raise ConfigError(
            f"row_block must be a non-negative integer, got {rb!r}", code=1
        )
    return rb_int


def _parse_weight_precision(par: dict) -> str:
    prec = str(par.get("weight_precision", "high"))
    if prec not in ("high", "highest", "default"):
        raise ConfigError(
            f"weight_precision must be 'high', 'highest' or 'default', "
            f"got {prec!r}",
            code=1,
        )
    return prec
