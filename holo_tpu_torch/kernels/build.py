"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``holo_tpu_torch/csrc/`` (the blocked engine's kernels,
the gather engine's, its multipath kernels and its fused round, the BGP
table's fold, the tropical engine's tile relax and count contraction) are
compiled at first use for ``sm_90a``, one ``nvcc`` per source, all started
together, and linked into one library in ``holo_tpu_torch/build/`` (listed in ``.gitignore``), named
by a hash of the sources so an edit rebuilds it.  Each C entry point takes ``void*``
pointers (NULL for an absent plane), ``int`` sizes and the CUDA stream,
launches on that stream and returns ``cudaGetLastError()``;
``holo_bgp_fold_smem``, ``holo_ell_fused_info``, ``holo_trop_info`` and
``holo_trop_count_info`` launch nothing: the first returns the fold's
shared-memory bytes a block, the other three write the fused round's, the
tile relax's or the count round's launch geometry and register counts.

A library that cannot be built or loaded raises :class:`KernelBuildError`,
which the dispatch breaker re-raises without counting it; a CUDA error at
launch raises ``RuntimeError``, a device failure that the breaker counts
before it re-raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "blocked_kernels.cu", _PKG / "csrc" / "ell_kernels.cu",
           _PKG / "csrc" / "mp_kernels.cu", _PKG / "csrc" / "bgp_kernels.cu",
           _PKG / "csrc" / "fused_kernels.cu", _PKG / "csrc" / "tropical_kernels.cu")
BUILD_DIR = _PKG / "build"
CUDA_HOME = "/usr/local/cuda"  # where nvcc is looked for after $CUDA_HOME
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (all return int).  The library also
# exports holo_error_string(int) -> const char*.
SIGNATURES = {
    "holo_blocked_relax": (*[_P] * 8, _I, _I, _P),
    "holo_blocked_dmin_parent": (*[_P] * 10, _I, _I, _P),
    "holo_blocked_nh_or": (*[_P] * 12, _I, _I, _I, _P),
    "holo_ell_relax": (*[_P] * 9, _I, _I, _I, _P),
    "holo_ell_first_parent": (*[_P] * 8, _I, _I, _I, _P),
    "holo_ell_nh_seed": (*[_P] * 6, _I, _I, _I, _I, _P),
    "holo_ell_nh_round": (*[_P] * 7, _I, _I, _I, _I, _P),
    "holo_ell_mp_round": (*[_P] * 18, _I, _I, _I, _I, _P),
    "holo_ell_parent_sets": (*[_P] * 10, _I, _I, _I, _I, _P),
    "holo_ell_parent_weights": (*[_P] * 3, _I, _I, _I, _P),
    "holo_ell_fused_round": (*[_P] * 17, *[_I] * 5, _P),
    "holo_ell_fused_info": (_I, _I, _I, _P, _P, _P),
    "holo_bgp_fold": (*[_P] * 12, *[_I] * 9, _P),
    "holo_bgp_fold_smem": (_I,) * 5,
    "holo_trop_relax": (*[_P] * 8, *[_I] * 4, _P),
    "holo_trop_repair": (_P, _I, *[_P] * 10, *[_I] * 3, _P),
    "holo_trop_count": (*[_P] * 8, *[_I] * 5, _P),
    "holo_trop_info": (_I, _I, _I, _P),
    "holo_trop_count_info": (_I, _I, _I, _P),
}

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """The kernel library could not be built or loaded (no ``nvcc``, a
    compile or link that failed, a library that does not load or bind).
    The device path is missing, not failing."""


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then :data:`CUDA_HOME`/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                               "on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)).hexdigest()[:12]
    return BUILD_DIR / f"holo_kernels-{digest}.so"


def _start(name: str, cmd: list) -> tuple:
    """(name, process) of one compiler call."""
    try:
        return name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)
    except OSError as exc:
        raise KernelBuildError(f"nvcc could not start for {name}: {exc}") from exc


def _run(procs: list) -> str:
    """Wait for every (name, process); raise naming the first that failed."""
    out, failed = "", None
    for name, proc in procs:
        stdout, stderr = proc.communicate()
        out += stdout + stderr
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed on {name} (rc {proc.returncode}):\n{stdout}{stderr}"
    if failed:
        raise KernelBuildError(failed)
    return out


def build(verbose: bool = False) -> Path:
    """Compile the kernel sources unless their library is already built.

    ``verbose`` adds ``-Xptxas -v`` and returns with the compiler's report
    printed (registers, shared memory and spills per kernel).
    """
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    flags = [*NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ())]
    objs = [tmp / f"{src.stem}.o" for src in SOURCES]
    try:
        report = _run([_start(src.name, [nvcc(), *flags, "-c", "-o", str(obj), str(src)])
                       for src, obj in zip(SOURCES, objs)])
        lib = tmp / "lib.so"
        link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        report += _run([_start("the link", link)])
        if verbose:
            print(report, end="", flush=True)
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The bound kernel library, built at first use.  Raises
    :class:`KernelBuildError` where it cannot be built, loaded or bound.
    The first build and bind run under a lock: two threads (a dispatch
    pipeline's worker and its caller) never build the library at once."""
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        return _load_locked()


def _load_locked() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.holo_error_string.argtypes = (_I,)
            lib.holo_error_string.restype = ctypes.c_char_p
        except (OSError, AttributeError) as exc:
            raise KernelBuildError(f"kernel library {path} does not load: {exc}") from exc
        _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.holo_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")


def on_card(*tensors) -> bool:
    """True for CUDA inputs (validated for a kernel), False for CPU ones;
    None entries (an absent plane) are skipped.  Raises on inputs split
    across devices or not contiguous int32."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    if all(t.device.type == "cpu" for t in ts):
        return False
    for t in ts:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"kernel inputs must all lie on one CUDA device or all on the "
                f"CPU, got {t.device} beside {dev}"
            )
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"kernel inputs must be contiguous int32, got {t.dtype} "
                f"(contiguous={t.is_contiguous()})"
            )
    return True


def launch(symbol: str, *args) -> None:
    """Call the C entry point ``symbol`` with tensors passed as pointers
    (None as NULL) and the current stream last; raise on a CUDA error."""
    lib = load()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    check(lib, getattr(lib, symbol)(*ptrs, torch.cuda.current_stream().cuda_stream), symbol)
