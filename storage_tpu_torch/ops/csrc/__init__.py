"""Build and load the package's CUDA kernels.

The ``.cu`` sources in this directory are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, and linked into one shared library with a plain C
interface, at first use, and loaded with :mod:`ctypes`.  The library lands
in ``storage_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library never
loads.

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
_SOURCES = ("backward_update.cu", "forward_sim.cu", "path_sim.cu")
_HEADERS = ("storage_kernels.cuh",)
BUILD_DIR = _SRC_DIR.parent.parent / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a", "-Xcompiler", "-fPIC",
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


def compile_library(src_dir: Path, sources, target: Path, verbose: bool = False) -> None:
    """Compile ``sources`` (file names in ``src_dir``) for Hopper, one ``nvcc``
    per source, all started together, and link them into the shared library
    ``target``.  ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel) and prints nvcc's output."""
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objects = [os.path.join(tmp, Path(src).stem + ".o") for src in sources]
        cmds = [[nvcc, *flags, "-c", "-o", obj, str(Path(src_dir) / src)]
                for src, obj in zip(sources, objects)]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)) for cmd in cmds]
        outputs = []
        for cmd, proc in procs:
            out, err = proc.communicate()
            outputs.append((cmd, proc.returncode, out + err))
        lib = os.path.join(tmp, "lib.so")
        if all(rc == 0 for _, rc, _ in outputs):
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]
            proc = subprocess.run(link, capture_output=True, text=True)
            outputs.append((link, proc.returncode, proc.stdout + proc.stderr))
        failed = [o for o in outputs if o[1] != 0]
        if failed:
            raise KernelBuildError("\n".join(
                f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}" for cmd, rc, text in failed))
        if verbose:
            print("".join(text for _, _, text in outputs))
        os.replace(lib, target)  # atomic: a concurrent process never loads a partial file


def build(verbose: bool = False) -> Path:
    """Compile the package's kernels if no library for the current sources
    exists (with ``verbose``, always, printing ``-Xptxas -v``).  Returns the
    library's path."""
    target = library_path()
    if not target.exists() or verbose:
        compile_library(_SRC_DIR, _SOURCES, target, verbose)
    return target


def load(path: Path) -> ctypes.CDLL:
    """Load a kernel library built by :func:`build` and declare its entry points."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    _declare(lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.backward_update_launch.argtypes = [p] * 11 + [ll, i, i, i, i, p, p, i, p]
    lib.backward_update_launch.restype = i
    lib.backward_update_blocks.argtypes = [ll, i, i]
    lib.backward_update_blocks.restype = i
    lib.forward_sim_launch.argtypes = [p] * 8 + [ll] + [i] * 8 + [p, p, i, i, p]
    lib.forward_sim_launch.restype = i
    lib.forward_sim_blocks.argtypes = [ll] + [i] * 6 + [p, p]
    lib.forward_sim_blocks.restype = i
    lib.forward_sim_row_pitch.argtypes = [i]
    lib.forward_sim_row_pitch.restype = i
    lib.path_sim_launch.argtypes = [p, p, p, p, ll, ll, i, i, i, i, p]
    lib.path_sim_launch.restype = i
    lib.storage_kernels_error_string.argtypes = [i]
    lib.storage_kernels_error_string.restype = ctypes.c_char_p


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
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
