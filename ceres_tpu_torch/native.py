"""The port's native host library: build and ctypes bindings of
csrc/ceres_native.cpp.

Counterpart of ceres_tpu/native/__init__.py, the host half of
SPARSE_NORMAL_CHOLESKY, the SUBSET preconditioner and the scalable
Covariance path: fill-reducing orderings (reverse Cuthill-McKee and a
quotient-graph minimum degree, the AMD role), a simplicial LDL^T over a
fixed pattern (analyze once, refactor every iteration) and the scatter of
Gram values into the CSC pattern.

The library builds at first use into ``ceres_tpu_torch/_build/`` with
``g++ -O3 -shared -fPIC -std=c++17`` (the JAX package's flags, so a factor
of the same matrix gives the same bits in both), keyed by a hash of the
source and the flags, as ops/_cuda.py keys the CUDA libraries. A missing
compiler, a failed build or a failed load raises with the compiler's
output: no path falls back to a dense factorization.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "ceres_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` into `build_dir` unless a library with the same
    hash of source and flags exists; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    source = Path(source)
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    out = Path(build_dir) / f"libceres_native_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) found: the native "
                           "library of ceres_tpu_torch cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building the native library failed:\n"
                           + " ".join(cmd) + "\n" + proc.stdout
                           + proc.stderr)
    os.replace(tmp, out)
    return out


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and set its entry points' types."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading the native library {path} failed: "
                           f"{e}") from e
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    sigs = {
        "ct_rcm_order": ([i32, p_i64, p_i32, p_i32], i32),
        "ct_amd_order": ([i32, p_i64, p_i32, p_i32], i32),
        "ct_chol_create": ([i32, p_i64, p_i32, i32], ctypes.c_void_p),
        "ct_chol_nnz": ([ctypes.c_void_p], i64),
        "ct_chol_factor": ([ctypes.c_void_p, p_f64], i32),
        "ct_chol_solve": ([ctypes.c_void_p, p_f64, p_f64], i32),
        "ct_chol_destroy": ([ctypes.c_void_p], None),
        "ct_chol_diag_stats": ([ctypes.c_void_p, p_f64], None),
        "ct_scatter_add": ([p_f64, p_i64, p_f64, i64], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def rcm_order(Ap: np.ndarray, Ai: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[new] = old)."""
    perm = np.empty(n, dtype=np.int32)
    library().ct_rcm_order(n, np.ascontiguousarray(Ap, np.int64),
                           np.ascontiguousarray(Ai, np.int32), perm)
    return perm


def amd_order(Ap: np.ndarray, Ai: np.ndarray, n: int) -> np.ndarray:
    """Quotient-graph minimum-degree permutation (perm[new] = old), the
    fill-reducing role of SuiteSparse CAMD (reorder_program.cc:95)."""
    perm = np.empty(n, dtype=np.int32)
    library().ct_amd_order(n, np.ascontiguousarray(Ap, np.int64),
                           np.ascontiguousarray(Ai, np.int32), perm)
    return perm


class SparseCholesky:
    """Simplicial LDL^T over a fixed symmetric pattern: analyze once,
    refactor each iteration (the reference's SparseCholesky contract,
    sparse_cholesky.h:72: Factorize on a constant pattern, then Solve)."""

    ORDER_NATURAL, ORDER_RCM, ORDER_AMD, ORDER_AUTO = 0, 1, 2, 3

    def __init__(self, n: int, Ap: np.ndarray, Ai: np.ndarray,
                 ordering: int = None):
        """ordering: 0 natural, 1 RCM, 2 AMD, 3 auto (the lesser symbolic
        fill of RCM and AMD); None: auto."""
        self._lib = library()
        self.n = int(n)
        self._Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        self._Ai = np.ascontiguousarray(Ai, dtype=np.int32)
        if ordering is None:
            ordering = self.ORDER_AUTO
        self._h = self._lib.ct_chol_create(self.n, self._Ap, self._Ai,
                                           int(ordering))
        if not self._h:
            raise RuntimeError("ct_chol_create failed")

    @property
    def factor_nnz(self) -> int:
        return int(self._lib.ct_chol_nnz(self._h))

    def factor(self, Ax: np.ndarray) -> int:
        """Numeric refactorization: 0 on success, k + 1 for a breakdown at
        column k."""
        return int(self._lib.ct_chol_factor(
            self._h, np.ascontiguousarray(Ax, dtype=np.float64)))

    def solve(self, b: np.ndarray, out: np.ndarray = None) -> np.ndarray:
        """x with A x = b from the last factor (into `out` when given, an
        f64 [n] contiguous array)."""
        x = np.empty(self.n, dtype=np.float64) if out is None else out
        self._lib.ct_chol_solve(
            self._h, np.ascontiguousarray(b, dtype=np.float64), x)
        return x

    def diag_stats(self):
        """(min |D|, max |D|, number of negative D) of the last factor: the
        inertia and conditioning that the covariance rank policy reads
        (covariance.h:281-329)."""
        out = np.empty(3, dtype=np.float64)
        self._lib.ct_chol_diag_stats(self._h, out)
        return float(out[0]), float(out[1]), int(out[2])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ct_chol_destroy(self._h)
            self._h = None


def scatter_add(out: np.ndarray, idx: np.ndarray, vals: np.ndarray):
    """out[idx] += vals in order, entries with idx == -1 skipped."""
    library().ct_scatter_add(out, np.ascontiguousarray(idx, np.int64),
                             np.ascontiguousarray(vals, np.float64),
                             np.int64(vals.size))
