"""The study harnesses of the port: the JAX side's tools, run on the card.

Each is ``python -m abcsmc_tpu_torch.tools.<name>`` and ``main(argv=None)``,
and ports one JAX file (that file stays the JAX side's):

| module | ports |
| --- | --- |
| ``bench_weight_kernel`` | ``tools/bench_weight_kernel.py`` |
| ``sweep_weight_kernel`` | ``tools/sweep_weight_kernel.py`` |
| ``bench_scale`` | ``tools/bench_scale.py`` |
| ``mirror_scale`` | ``tools/mirror_scale.py`` |
| ``bench_reference_shape`` | ``tools/bench_reference_shape.py`` |
| ``quickstart_chip`` | ``tools/quickstart_chip.py`` |
| ``stat_validate`` | ``tools/tpu_stat_validate.py`` |
| ``calibration_study`` | ``tools/calibration_study.py`` |
| ``million_run`` | ``examples/million_run.py`` |
| ``bench_native`` | ``tools/bench_native.py`` |
| ``scaling_analysis`` | ``tools/scaling_analysis.py`` |
| ``validate`` | ``tools/tpu_validate.py`` |
| ``gen_dengue_surrogate`` | ``examples/gen_dengue_surrogate.py`` |

Common to all (:mod:`abcsmc_tpu_torch.tools._common`): ``--device``
(default ``cuda``; without CUDA and without ``--device cpu`` the harness
exits 2), ``--seed``, ``--out`` (a copy of the JSON lines); the first
line names the card. They write nothing else: no file under ``docs/``.
``gen_dengue_surrogate`` takes ``--device`` alone, under the same rule,
and writes a config to stdout, as its JAX script does.
"""
