"""Build of the embedded-interpreter C API shim (ceres_tpu_torch_c.cpp).

Counterpart of ceres_tpu/capi/__init__.py. `build()` compiles the shim
with g++ against the running Python's embedding flags
(`python3-config --includes` and `--embed --ldflags`) into
``ceres_tpu_torch/_build/capi_<hash>/libceres_tpu_torch_c.so``, keyed by
a hash of the source, the header and the flags, as native.py keys its
library; a C program links it with ``-L<dir> -lceres_tpu_torch_c``. A
missing toolchain or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "ceres_tpu_torch_c.cpp"
HEADER = _DIR / "ceres_tpu_torch_c.h"
BUILD_DIR = _DIR.parent / "_build"
LIB_NAME = "libceres_tpu_torch_c.so"

_lock = threading.Lock()


def _py_config(*flags) -> list:
    exe = shutil.which("python3-config")
    if exe is None:
        raise RuntimeError("python3-config not found: the C API shim needs "
                           "Python's embedding flags")
    proc = subprocess.run([exe, *flags], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"python3-config {' '.join(flags)} failed:\n"
                           + proc.stdout + proc.stderr)
    return proc.stdout.split()


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the shim unless a build with the same hash exists; returns
    the library's path (its directory is the one to link against)."""
    with _lock:
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++, or $CXX) found: the "
                               "C API shim cannot be built")
        flags = (["-O2", "-shared", "-fPIC"] + _py_config("--includes"),
                 _py_config("--embed", "--ldflags"))
        h = hashlib.sha256(repr(flags).encode())
        h.update(SRC.read_bytes())
        h.update(HEADER.read_bytes())
        out = Path(build_dir) / f"capi_{h.hexdigest()[:16]}" / LIB_NAME
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *flags[0], str(SRC), "-o", str(tmp), *flags[1]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("building the C API shim failed:\n"
                               + " ".join(cmd) + "\n" + proc.stdout
                               + proc.stderr)
        os.replace(tmp, out)
        return out
