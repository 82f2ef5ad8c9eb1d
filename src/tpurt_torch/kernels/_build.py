"""Build and load the CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface, which is loaded with ctypes.  The library lives in
``_build/`` beside this file (ignored by git), named by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is not.  A
missing toolchain or a failed compile raises: nothing falls back to the
plain-torch twins.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# -fmad=false: no FMA contraction, so the kernels round like the plain-torch
# twins and like tpurt.  Never --use_fast_math (flushes denormals and
# approximates division).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"tpurt_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless an up-to-date one exists; returns its path.
    The compiler's output (ptxas register and spill report) is kept beside
    it as ``.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    with open(path[:-3] + ".log", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.tpurt_closest8.argtypes = [
            _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            _P, _P, _P, _P, _P, _P, _P, _P]
        lib.tpurt_closest8.restype = ctypes.c_int
        lib.tpurt_occluded8.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            _P, _P]
        lib.tpurt_occluded8.restype = ctypes.c_int
        lib.tpurt_knear8.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, _P, _P]
        lib.tpurt_knear8.restype = ctypes.c_int
        lib.tpurt_error_string.argtypes = [ctypes.c_int]
        lib.tpurt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return f"{err} ({load().tpurt_error_string(err).decode()})"
