"""Build and load the hand-written CUDA kernels at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The library lands in ``build/kernels/`` at the root of the
checkout, named by a hash of its source, the files it includes by a quoted
name and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: seconds spent in nvcc per library name (0.0 when a cached build was reused)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    """Path of nvcc: $PATH first, then $CUDA_HOME/bin, then /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of abcsmc_tpu_torch are built from csrc/ at first use"
    )


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_bytes(src: str | Path) -> bytes:
    """The bytes of ``src`` and, after them, of each file it includes by a
    quoted name (found beside the file that includes it), each once, in
    the order they are first included."""
    seen: list[Path] = []

    def walk(path: Path):
        path = path.resolve()
        if path in seen:
            return
        seen.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            walk(path.parent / inc)

    walk(Path(src))
    return b"".join(p.read_bytes() for p in seen)


def load_library(name: str, src: str | Path | None = None) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu``, or ``src`` when given (if no build of
    this exact source exists), and return the loaded library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = Path(src) if src is not None else CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            source_bytes(src) + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        build_seconds[name] = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}"
                )
            # atomic publish: a concurrent process never loads a partial file
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
        return lib
