"""Build and load the package's CUDA kernel (``csrc/flash_attention.cu``).

The source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  The library goes
to ``build/mxnet_tpu_torch/`` at the root of the checkout, named by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  A missing ``nvcc`` or a failed build raises with the
compiler's output; nothing falls back to another implementation.  The
compiler's output of a build that succeeds (``ptxas -v``: registers, spill
bytes and static shared memory per kernel instance) is kept beside the
library and read back by :func:`build_log`.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

__all__ = ["load", "build_log", "library_path"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
              / "mxnet_tpu_torch")
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# q, k, v, o, dtype, B, H, Tq, Tk, D, 9 strides, causal, causal_offset,
# scale, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 9 + [
    _I, _I, _F, _P]

_lock = threading.Lock()
_lib = None


def _nvcc():
    home = os.environ.get("CUDA_HOME")
    candidates = ([Path(home) / "bin" / "nvcc"] if home else []) + [
        _DEFAULT_NVCC]
    for path in candidates:
        if path.is_file():
            return str(path)
    raise MXNetError("nvcc not found (looked in %s); the CUDA kernels are "
                     "built from source and need the CUDA toolkit"
                     % ", ".join(str(p) for p in candidates))


def library_path():
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / ("libflash_attention-%s.so" % digest[:16])


def _build(out):
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.tmp-%d" % (out.name, os.getpid()))
    cmd = [_nvcc()] + _NVCC_FLAGS + ["-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError("building the flash-attention kernel failed "
                         "(exit %d):\n%s\n%s"
                         % (proc.returncode, " ".join(cmd), proc.stdout))
    _log_path(out).write_text(proc.stdout)
    os.replace(tmp, out)
    return proc.stdout


def _log_path(lib):
    return lib.with_suffix(".log")


def build_log():
    """What ``nvcc`` printed when it built the loaded library."""
    load()
    return _log_path(library_path()).read_text()


def load():
    """The kernel's ctypes library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.mxt_flash_attention_fwd.argtypes = _ARGTYPES
            lib.mxt_flash_attention_fwd.restype = ctypes.c_int
            _lib = lib
        return _lib
