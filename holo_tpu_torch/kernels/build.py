"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

``holo_tpu_torch/csrc/blocked_kernels.cu`` is compiled at first use for
``sm_90a`` into ``holo_tpu_torch/build/`` (listed in ``.gitignore``), as a
library named by a hash of the source so an edit rebuilds it.  Each C
entry point takes ``void*`` pointers, ``int`` sizes and the CUDA
stream, launches on that stream and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "blocked_kernels.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (all return int).  The library also
# exports holo_error_string(int) -> const char*.
SIGNATURES = {
    "holo_blocked_relax": (*[_P] * 8, _I, _I, _P),
    "holo_blocked_dmin_parent": (*[_P] * 10, _I, _I, _P),
    "holo_blocked_nh_or": (*[_P] * 12, _I, _I, _I, _P),
}

_LIB: ctypes.CDLL | None = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{SOURCE.stem}-{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernel source unless its library is already built.

    ``verbose`` adds ``-Xptxas -v`` and returns with the compiler's report
    printed (registers, shared memory and spills per kernel).
    """
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {SOURCE.name} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, end="", flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.holo_error_string.argtypes = (_I,)
        lib.holo_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.holo_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
