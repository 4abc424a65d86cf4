"""Native (C++) host kernels.

The device owns the tensor math; the native library speeds up the sequential
host-side setup: the inventory-space reduction (``csrc/storage_host_ops.cpp``,
the analogue of the reference's natively compiled ``StorageHelper`` and
constraint machinery, SURVEY.md §2.2).  It is the JAX package's C++ source,
read in place and built with the JAX package's loader's flags exactly, so
both packages' libraries compute the same bits.

The library is built with ``g++`` on first use into the port's
``storage_tpu_torch/_build/``, under a name carrying a hash of the source and
flags (so an edited source is rebuilt and a stale library never loads).  If
``g++`` is missing or the build fails, callers fall back to the NumPy
implementation, and a WARNING says so.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("storage_tpu_torch.native")

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO_ROOT / "csrc" / "storage_host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The JAX package's loader's flags: no -march=native, no -ffast-math.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libstorage_host_ops_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile to a temporary file beside ``target`` and rename it into place
    atomically, so a concurrent process never loads a partial library."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{target.name}.", suffix=".tmp", dir=target.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            lib.stpu_abi_version.restype = ctypes.c_int
            if lib.stpu_abi_version() != ABI_VERSION:
                raise OSError("ABI version mismatch")
            lib.stpu_inventory_space.restype = ctypes.c_int
            lib.stpu_inventory_space.argtypes = [
                ctypes.POINTER(ctypes.c_double),  # pillars
                ctypes.POINTER(ctypes.c_int32),  # pillar_counts
                ctypes.c_int32,  # max_pillars
                ctypes.c_int32,  # n_steps
                ctypes.c_int32,  # interp_kind
                ctypes.POINTER(ctypes.c_double),  # min_inv
                ctypes.POINTER(ctypes.c_double),  # max_inv
                ctypes.POINTER(ctypes.c_double),  # loss
                ctypes.c_double,  # start_inventory
                ctypes.c_int32,  # must_be_empty
                ctypes.POINTER(ctypes.c_double),  # out_min
                ctypes.POINTER(ctypes.c_double),  # out_max
            ]
            _lib = lib
        except (subprocess.SubprocessError, OSError, AttributeError, ValueError) as exc:
            # AttributeError: a library without the stpu_* symbols.
            logger.warning("Native inventory-space library unavailable (%s); "
                           "using the NumPy implementation.", exc)
            _load_failed = True
    return _lib


def native_available() -> bool:
    return load() is not None


def inventory_space_native(
    pillar_tables,
    interp_kind: int,
    min_inv: np.ndarray,
    max_inv: np.ndarray,
    loss: np.ndarray,
    starting_inventory: float,
    must_be_empty_at_end: bool,
):
    """Native inventory-space reduction.

    Returns ``(min, max)`` arrays, or ``None`` if the library is unavailable
    or refuses its arguments.  Raises
    :class:`InventoryConstraintsCannotBeFulfilledError` on infeasible
    configurations, as the NumPy implementation does.
    """
    lib = load()
    if lib is None:
        return None
    from ..exceptions import InventoryConstraintsCannotBeFulfilledError

    n = len(pillar_tables)
    max_pillars = max(t.shape[0] for t in pillar_tables)
    pillars = np.empty((n, max_pillars, 3), dtype=np.float64)
    counts = np.empty(n, dtype=np.int32)
    for k, t in enumerate(pillar_tables):
        counts[k] = t.shape[0]
        pillars[k, : t.shape[0]] = t
        pillars[k, t.shape[0]:] = t[-1]

    min_inv = np.ascontiguousarray(min_inv, dtype=np.float64)
    max_inv = np.ascontiguousarray(max_inv, dtype=np.float64)
    loss = np.ascontiguousarray(loss, dtype=np.float64)
    out_min = np.empty(n + 1, dtype=np.float64)
    out_max = np.empty(n + 1, dtype=np.float64)

    def ptr(arr, typ=ctypes.c_double):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    status = lib.stpu_inventory_space(
        ptr(pillars), ptr(counts, ctypes.c_int32),
        np.int32(max_pillars), np.int32(n), np.int32(interp_kind),
        ptr(min_inv), ptr(max_inv), ptr(loss),
        ctypes.c_double(float(starting_inventory)),
        np.int32(1 if must_be_empty_at_end else 0),
        ptr(out_min), ptr(out_max),
    )
    if status == 1:
        raise InventoryConstraintsCannotBeFulfilledError()
    if status != 0:
        return None  # bad arguments: the caller falls back to NumPy
    return out_min, out_max
