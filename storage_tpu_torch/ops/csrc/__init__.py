"""Build and load the package's CUDA kernels.

The ``.cu`` sources in this directory are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with a
plain C interface, at first use, and loaded with :mod:`ctypes`.  The library
lands in ``storage_tpu_torch/_build/`` under a name that carries a hash of
the sources, so an edited source is rebuilt and a stale library never loads.

Nothing here runs at import: :func:`kernels` builds on its first call, and
raises :class:`KernelBuildError` (with nvcc's output) if the build fails.
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
from typing import Optional

_SRC_DIR = Path(__file__).resolve().parent
_SOURCES = ("backward_update.cu", "forward_sim.cu")
_HEADERS = ("storage_kernels.cuh",)
BUILD_DIR = _SRC_DIR.parent.parent / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """The CUDA sources could not be compiled or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused or failed."""


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (looked in CUDA_HOME, PATH and /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _HEADERS + _SOURCES:
        h.update(name.encode())
        h.update((_SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libstorage_kernels_{_source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for the current sources exists.

    Returns the library's path.  ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory and spills per kernel) and prints nvcc's output.
    """
    target = library_path()
    if target.exists() and not verbose:
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp] + [str(_SRC_DIR / s) for s in _SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, target)  # atomic: a concurrent process never loads a partial file
    return target


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.backward_update_launch.argtypes = [p] * 12 + [ll, i, i, i, i, p, p, i, p]
    lib.backward_update_launch.restype = i
    lib.forward_sim_launch.argtypes = [p] * 13 + [ll, i, i, i, i, i, i, i, i, p, p, i, p]
    lib.forward_sim_launch.restype = i
    lib.storage_kernels_error_string.argtypes = [i]
    lib.storage_kernels_error_string.restype = ctypes.c_char_p


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _declare(lib)
            _lib = lib
        return _lib


def check_operand(name: str, t, shape, dtype=None) -> None:
    """Validate one kernel operand: a contiguous CUDA tensor of ``dtype``
    (default float32) and ``shape``.  Raises ``ValueError`` otherwise."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); the kernel "
                         "never runs on the CPU")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def basis_arrays(spec):
    """A basis spec's exponents as the host int arrays the launchers take:
    ``spot_pow [B]`` and ``fac_pow [B, F]`` (row-major)."""
    B = spec.num_basis
    F = len(spec.factor_powers[0])
    spot_pow = (ctypes.c_int * B)(*spec.spot_powers)
    fac_pow = (ctypes.c_int * (B * F))(*[p for row in spec.factor_powers for p in row])
    return spot_pow, fac_pow


def check_launch(name: str, err: int) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero ``cudaError_t``."""
    if err:
        msg = kernels().storage_kernels_error_string(err).decode()
        raise KernelLaunchError(f"{name} launch failed: {msg} (cudaError {err})")
