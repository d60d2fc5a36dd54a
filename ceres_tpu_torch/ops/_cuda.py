"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All kernels compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``: one ``nvcc -c`` per source, all started
together, then one link. The build runs at first use into
``ceres_tpu_torch/_build/``, keyed by a hash of the sources and flags, so a
fresh checkout builds everything itself. A missing ``nvcc`` or a failed
build raises: nothing falls back.

A second route builds generated units (`build_generated`): a source
that a module writes at run time (K5's unit, the jet chain of one
functor emitted by ops/jet_compile.py around ``csrc/lin_auto.cuh``;
K11's auto-spec unit, a row chain around ``csrc/linearize_auto.cuh``) goes
to ``_build/<tag>_<hash>.cu`` and compiles with the same flags and ``-I
csrc`` into its own shared library, keyed by a hash of the headers, the
source and the flags, loaded with ``ctypes``; it raises as `build` does.

Each C entry point launches on the stream it is given, synchronises
nothing, allocates nothing, and returns ``cudaGetLastError()``.

The launch path is lean, since the CG loops launch the small kernels
tens of thousands of times a solve and the host sets their time: each
entry point is resolved once per process into a cached ctypes function
(`_ENTRY`, read without a lock), the stream pointer comes from one call
into PyTorch's C layer, and `check` tests a tensor with one boolean
chain, building its message only when it fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns a CUDA error code (int)
_SIGNATURES = {
    # K1 takes K5's arguments (generated units' ceres_lin_auto, argtypes
    # set by ops/lin_auto.py from this list)
    "ceres_lin": [_P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_float), _I, _P,
                  _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P],
    # K1's instances with a robust loss take the same arguments
    **{f"ceres_lin_{name}": None for name in (
        "huber", "soft_l_one", "cauchy", "arctan", "tolerant", "tukey")},
    "ceres_elim": [_P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I,
                   _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "ceres_elim_v1": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P, _P],
    "ceres_chol_solve": [_P, _P, _I, _I, _P, _P, _P],
    "ceres_chol_solve_shared": [_P, _P, _I, _I, _P, _P],
    "ceres_fast_math_check": [_P, _P, _I, _I, _P, _P, _P, _P],
    "ceres_pcg": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                  _P, _P, _P, _P],
    "ceres_cost": [_P, ctypes.c_long, ctypes.c_long, _P, _P, _P, _P, _I,
                   _P, _P],
    "ceres_linearize": [_I, _P, _P, _I, _P, _P, _P],
    "ceres_jtjv": [_P, _P, _P, _I, _I, _I, _P, _P],
    "ceres_gram_group": [_P, _I, _P, _P, _I, _I, _P, _P],
    "ceres_implicit_apply": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P, _P],
}
for _name, _types in _SIGNATURES.items():
    if _types is None:
        _SIGNATURES[_name] = _SIGNATURES["ceres_lin"]

_lock = threading.Lock()
_lib = None
_generated = {}                 # library path -> loaded ctypes.CDLL
_ENTRY = {}                     # entry point name -> ctypes function


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "ceres_tpu_torch cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into _build/ unless a library with the same
    source hash exists. Returns the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libceres_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, proc in procs:        # wait for every compile, then report
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + " ".join(cmd) + "\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call); fills `_ENTRY`."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _ENTRY[name] = fn
            _lib = lib
    return _lib


def build_generated(tag: str, source: str) -> ctypes.CDLL:
    """Compile a generated CUDA unit (which may include csrc/*.cuh) into
    its own shared library under _build/, unless one with the same hash
    of headers, source and flags exists, and load it. The caller sets the
    argtypes of its entry points."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(source.encode())
    stem = f"{tag}_{h.hexdigest()[:16]}"
    out = BUILD_DIR / f"lib{stem}.so"
    with _lock:
        if str(out) in _generated:
            return _generated[str(out)]
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = BUILD_DIR / f"{stem}.cu"
        tmp_src = src.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                  ".cu")
        tmp_src.write_text(source)
        os.replace(tmp_src, src)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
               str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on a generated unit:\n"
                               + " ".join(cmd) + "\n" + proc.stdout
                               + proc.stderr)
        os.replace(tmp, out)
    with _lock:
        if str(out) not in _generated:
            _generated[str(out)] = ctypes.CDLL(str(out))
        return _generated[str(out)]


def call(fn, name: str, *args) -> None:
    """Call the C entry point `fn` on the current CUDA stream of the
    current device; raise if the launch failed. Tensor arguments must
    already be checked by the caller."""
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args],
             torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def launch(name: str, *args) -> None:
    """Call one entry point of the kernel library (see `call`)."""
    fn = _ENTRY.get(name)
    if fn is None:
        library()
        fn = _ENTRY[name]
    call(fn, name, *args)


_SMS = {}                       # device index -> SM count


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (cached)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def check(t, shape, dtype, name: str) -> None:
    """Raise unless tensor t is a contiguous CUDA tensor of this shape and
    dtype."""
    if t.is_cuda and t.dtype == dtype and t.shape == shape \
            and t.is_contiguous():
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    raise ValueError(f"{name}: expected a contiguous tensor")
