"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library of its own with a plain C interface, loaded with ``ctypes``:
``csrc/flash_attention.cu`` and ``csrc/greedy_nms.cu``.  A library goes to
``build/mxnet_tpu_torch/`` at the root of the checkout, named by a hash of
its source and the flags, so an edited source rebuilds only its own
library and an unchanged one is reused.  A missing ``nvcc`` or a failed
build raises with the compiler's output; nothing falls back to another
implementation.  The compiler's output of a build that succeeds (``ptxas
-v``: registers, spill bytes and static shared memory per kernel
instance) is kept beside the library and read back by :func:`build_log`.
:func:`build_all` starts one ``nvcc`` a source, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .base import MXNetError

__all__ = ["load", "build_all", "build_log", "library_path", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
              / "mxnet_tpu_torch")
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_double)
# source name -> {C entry point: argtypes}
SOURCES = {
    # q, k, v, o, dtype, B, H, Tq, Tk, D, 9 strides, causal,
    # causal_offset, scale, stream
    "flash_attention": {"mxt_flash_attention_fwd": [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 9 + [
        _I, _I, _F, _P]},
    # boxes, ids (or null), words, B, K, thresh, form, box type, id type,
    # stream; then words, init, keep, B, K, stream
    "greedy_nms": {
        "mxt_greedy_nms_words": [_P, _P, _P, _I, _I, _D, _I, _I, _I, _P],
        "mxt_greedy_nms_scan": [_P, _P, _P, _I, _I, _P]},
}

_locks = {name: threading.Lock() for name in SOURCES}
_libs = {}


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


def _source(name):
    if name not in SOURCES:
        raise MXNetError("no CUDA source %r (have %s)"
                         % (name, ", ".join(sorted(SOURCES))))
    return _CSRC / ("%s.cu" % name)


def library_path(name="flash_attention"):
    """Where the library for source ``name``'s current text and the flags
    lives."""
    digest = hashlib.sha256(_source(name).read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / ("lib%s-%s.so" % (name, digest[:16]))


def _build(out, name):
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.tmp-%d" % (out.name, os.getpid()))
    cmd = [_nvcc()] + _NVCC_FLAGS + ["-o", str(tmp), str(_source(name))]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError("building the %s kernel failed (exit %d):\n%s\n%s"
                         % (name, proc.returncode, " ".join(cmd),
                            proc.stdout))
    _log_path(out).write_text(proc.stdout)
    os.replace(tmp, out)
    return proc.stdout


def _log_path(lib):
    return lib.with_suffix(".log")


def build_log(name="flash_attention"):
    """What ``nvcc`` printed when it built source ``name``'s library."""
    load(name)
    return _log_path(library_path(name)).read_text()


def load(name="flash_attention"):
    """Source ``name``'s ctypes library, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _source(name)
    with _locks[name]:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                _build(path, name)
            lib = ctypes.CDLL(str(path))
            for entry, argtypes in SOURCES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def build_all():
    """Build (or find) every source's library, one ``nvcc`` a source
    started together; raises the first failure.  Returns ``{name:
    seconds}``, each build's wall time."""
    def timed(name):
        t0 = time.time()
        load(name)
        return time.time() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(timed, name) for name in SOURCES}
    return {name: f.result() for name, f in futures.items()}
