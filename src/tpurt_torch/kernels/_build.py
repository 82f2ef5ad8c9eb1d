"""Build and load the CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` to an object, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which is loaded with ctypes.  The
library lives in ``_build/`` beside this file (ignored by git), named by a
hash of the flags and of every source and header under ``csrc/``, so a
changed file is rebuilt and an unchanged one is not.  A missing toolchain or
a failed compile raises: nothing falls back to the plain-torch twins.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# -fmad=false: no FMA contraction, so the kernels round like the plain-torch
# twins and like tpurt.  Never --use_fast_math (flushes denormals and
# approximates division).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def _sources(csrc: str | None = None) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc or CSRC, "*.cu")))


def _inputs(csrc: str | None = None) -> list[str]:
    """Every file under csrc/ that a build reads: sources and headers."""
    csrc = csrc or CSRC
    return sorted(p for p in glob.glob(os.path.join(csrc, "**", "*"), recursive=True)
                  if p.endswith((".cu", ".cuh", ".h", ".hpp")))


def library_path(csrc: str | None = None) -> str:
    """The library built from the sources in `csrc` (default csrc/), named
    by a hash of the flags and of every source and header."""
    csrc = csrc or CSRC
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _inputs(csrc):
        h.update(os.path.relpath(src, csrc).encode() + b"\0")
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"tpurt_kernels-{h.hexdigest()[:16]}.so")


def _run(procs: list) -> str:
    """Wait for every (cmd, Popen); raise on the first that failed, else
    return their output (the ptxas register and spill report)."""
    done = [(cmd, *p.communicate()) for cmd, p in procs]
    done = [(cmd, p.returncode, out, err) for (cmd, out, err), (_, p) in zip(done, procs)]
    for cmd, rc, stdout, stderr in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")
    return "".join(stdout + stderr for _, _, stdout, stderr in done)


def build(csrc: str | None = None) -> str:
    """Compile the library unless an up-to-date one exists; returns its path.
    The compiler's output (ptxas register and spill report) is kept beside
    it as ``.log``.  csrc: another source directory (chip_smoke.py builds a
    parent commit's kernels beside these to time them against each other)."""
    path = library_path(csrc)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in _sources(csrc):
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        log = _run(procs)
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", tmp,
               *objs]
        log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))])
        with open(path[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.tpurt_closest8.argtypes = [
            _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            _P, _P, _P, _P, _P, _P, _P, _P, _P]
        lib.tpurt_closest8.restype = ctypes.c_int
        lib.tpurt_occluded8.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            _P, _P, _P]
        lib.tpurt_occluded8.restype = ctypes.c_int
        lib.tpurt_knear8.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, _P, _P, _P]
        lib.tpurt_knear8.restype = ctypes.c_int
        lib.tpurt_closest_bin.argtypes = [
            _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_float, _P, _P, _P, _P, _P]
        lib.tpurt_closest_bin.restype = ctypes.c_int
        lib.tpurt_occluded_bin.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_float, _P, _P]
        lib.tpurt_occluded_bin.restype = ctypes.c_int
        lib.tpurt_knear_bin.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, _P, _P]
        lib.tpurt_knear_bin.restype = ctypes.c_int
        lib.tpurt_morton.argtypes = [_P, _P, _P, ctypes.c_float, ctypes.c_int, _P, _P]
        lib.tpurt_morton.restype = ctypes.c_int
        lib.tpurt_radix.argtypes = [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P]
        lib.tpurt_radix.restype = ctypes.c_int
        lib.tpurt_segsum_scan.argtypes = [
            _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
            _P]
        lib.tpurt_segsum_scan.restype = ctypes.c_int
        lib.tpurt_segsum_carry.argtypes = [
            _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
        lib.tpurt_segsum_carry.restype = ctypes.c_int
        lib.tpurt_segsum_ends.argtypes = [
            _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
        lib.tpurt_segsum_ends.restype = ctypes.c_int
        lib.tpurt_error_string.argtypes = [ctypes.c_int]
        lib.tpurt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_aligned(*ptrs: int) -> None:
    """Raise unless each device address is a multiple of 16: kernels that
    read rows as 16-byte vectors need aligned bases."""
    if any(p % 16 for p in ptrs):
        raise ValueError("a kernel that reads 16-byte vectors got a misaligned base")


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    """x's device address, as a kernel's pointer argument."""
    return ctypes.c_void_p(x.data_ptr())


def stream(dev: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of `dev`, as a kernel's stream argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def on_device(x: torch.Tensor) -> torch.cuda.device:
    """The context every kernel launch is made in: x's card made current,
    so that the launch, the wrapper's current_stream() and the library's
    cudaGetDevice() all refer to the card the tensors live on, not to
    whichever card happens to be current.  x must be a CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"a kernel launch needs a CUDA tensor, got one on {x.device}")
    return torch.cuda.device(x.device)


def error_string(err: int) -> str:
    return f"{err} ({load().tpurt_error_string(err).decode()})"
