"""Reference-ABI shared-object adapter.

The reference loads simulators from shared objects by ``dlsym``-ing an
unmangled ``simulator`` symbol whose type is nonetheless C++:

    vector<float_type> simulator(vector<float_type>,
                                 const unsigned long, const unsigned long)

(``AbcSimBase``, include/AbcSmc/AbcSim.h:55-58, loaded at
:96-114 via ``loadSO``; ``float_type`` is ``double``). That signature cannot
be called through ctypes, so existing reference simulator binaries could not
run against this framework's portable C ABI (``abc_simulator``,
models/simulators.py) without a recompile.

This module closes the gap: a tiny C++ shim, compiled on demand with the
system ``g++`` and cached by source hash, dlopens the reference ``.so`` and
re-exports the C ABI. ``SharedLibSimulator`` uses it transparently whenever a
target exports ``simulator`` but not ``abc_simulator`` - reference binaries
run unmodified.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

from abcsmc_tpu_torch.errors import SimulatorError

_SHIM_SOURCE = r"""
// Adapter: dlopen a reference-ABI simulator shared object (unmangled C++
// symbol `simulator`, include/AbcSmc/AbcSim.h:55-114) and
// re-export the framework's portable C ABI. Stateless across targets: a
// small path-keyed cache lets several distinct reference simulators coexist
// in one process.
#include <dlfcn.h>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

typedef std::vector<double> (*ref_sim_fn)(std::vector<double>,
                                          const unsigned long,
                                          const unsigned long);

static std::map<std::string, ref_sim_fn>& cache() {
    static std::map<std::string, ref_sim_fn> c;
    return c;
}

extern "C" int abc_ref_probe(const char* path) {
    // 0 = loadable reference simulator; 1 = dlopen failed; 2 = no `simulator`
    auto it = cache().find(path);
    if (it != cache().end()) return it->second ? 0 : 2;
    void* handle = dlopen(path, RTLD_LAZY | RTLD_LOCAL);
    if (!handle) { std::fprintf(stderr, "ref_shim: %s\n", dlerror()); return 1; }
    ref_sim_fn fn = (ref_sim_fn)dlsym(handle, "simulator");
    cache()[path] = fn;
    if (!fn) return 2;
    return 0;
}

extern "C" int abc_simulator_ref(const char* path,
                                 const double* pars, size_t npar,
                                 unsigned long seed, unsigned long serial,
                                 double* mets, size_t nmet) {
    int rc = abc_ref_probe(path);
    if (rc != 0) return -rc;
    ref_sim_fn fn = cache()[path];
    std::vector<double> p(pars, pars + npar);
    std::vector<double> out;
    try {
        out = fn(p, seed, serial);
    } catch (...) {
        return -10;  // simulator threw
    }
    if (out.size() != nmet) return (int)out.size() + 1000;  // count mismatch
    std::memcpy(mets, out.data(), nmet * sizeof(double));
    return 0;
}
"""


def _cache_dir() -> str:
    base = os.environ.get("ABCSMC_SHIM_CACHE") or os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"),
        "abcsmc_tpu_torch",
    )
    os.makedirs(base, exist_ok=True)
    return base


def build_shim() -> str:
    """Compile (or reuse) the reference-ABI shim; returns the .so path.
    Cached by source hash, so a source change never reuses a stale binary."""
    tag = hashlib.sha256(_SHIM_SOURCE.encode()).hexdigest()[:16]
    cache = _cache_dir()
    so_path = os.path.join(cache, f"libabcrefshim-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    # build INSIDE the cache dir: the final os.replace must be
    # same-filesystem (rename across mounts - e.g. tmpfs /tmp vs $HOME -
    # fails with EXDEV) and atomic so concurrent builds race safely
    with tempfile.TemporaryDirectory(dir=cache) as td:
        src = os.path.join(td, "ref_shim.cpp")
        with open(src, "w") as f:
            f.write(_SHIM_SOURCE)
        tmp_out = os.path.join(td, "shim.so")
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp_out, src,
                 "-ldl"],
                check=True, capture_output=True, text=True,
            )
        except FileNotFoundError:
            raise SimulatorError(
                "reference-ABI simulator requires g++ to build the adapter "
                "shim (none found); recompile the simulator against the C "
                "ABI instead (docs/MIGRATION.md)", code=-211,
            )
        except subprocess.CalledProcessError as e:
            raise SimulatorError(
                f"reference-ABI shim failed to compile: {e.stderr}",
                code=-211,
            )
        os.replace(tmp_out, so_path)
    return so_path


class ReferenceShim:
    """ctypes handle to the compiled shim, bound to one target ``.so``."""

    def __init__(self, target: str):
        self.target = os.path.abspath(target)
        lib = ctypes.CDLL(build_shim())
        probe = lib.abc_ref_probe
        probe.restype = ctypes.c_int
        probe.argtypes = [ctypes.c_char_p]
        rc = probe(self.target.encode())
        if rc == 1:
            raise SimulatorError(
                f"Failed to open simulator object: {target}", code=101
            )  # reference loadSO exits 101 (AbcSim.h:66-68)
        if rc == 2:
            raise SimulatorError(
                f"Failed to find 'simulator' function in {target}", code=102
            )  # reference loadSO exits 102 (AbcSim.h:70-74)
        self._fn = lib.abc_simulator_ref
        self._fn.restype = ctypes.c_int
        self._fn.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
            ctypes.c_ulong, ctypes.c_ulong,
            ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
        ]

    def __call__(self, row, seed: int, serial: int, nmet: int):
        pars = (ctypes.c_double * len(row))(*[float(v) for v in row])
        mets = (ctypes.c_double * nmet)()
        rc = self._fn(
            self.target.encode(), pars, len(row), int(seed), int(serial),
            mets, nmet,
        )
        if rc >= 1000:  # 1000 + out.size(); 1000 itself = empty vector
            # metric-count mismatch aborts in the reference too
            # (src/AbcSmc.cpp:683-687, exit -211)
            raise SimulatorError(
                "simulator function returned the wrong number of metrics: "
                f"expected {nmet}, received {rc - 1000}", code=-211,
            )
        if rc != 0:
            raise SimulatorError(
                f"reference-ABI simulator failed (rc={rc}) for serial "
                f"{serial}", code=-211,
            )
        return list(mets)


def has_reference_abi(soname: str) -> bool:
    """True when the target exports the reference's ``simulator`` symbol."""
    try:
        lib = ctypes.CDLL(os.path.abspath(soname))
    except OSError:
        return False
    return hasattr(lib, "simulator")
