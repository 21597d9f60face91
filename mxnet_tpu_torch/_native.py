"""The native IO library (counterpart of ``mxnet_tpu/_native.py``).

Compiles the unchanged ``src/recordio.cc``, ``src/pipeline.cc`` and
``src/im2rec.cc`` with ``g++`` into ``build/mxnet_tpu_torch/libmxtpu.so``
(the JAX package's copy, ``build/libmxtpu.so``, is never touched) and binds
its plain C interface with ``ctypes``.  The build rule is the JAX
package's: a full build linked with ``-ljpeg``, else a RecordIO-only build
(no decode pipeline, no im2rec) marked so that the next process tries the
full build again; a library newer than every source is reused.

Several processes may build at once (the test runner's workers): the build
holds an exclusive ``flock`` on a lock file beside the library, compiles
into a temporary name and ``os.replace``s it into place, so no process
loads a half-written library.  Nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

__all__ = ["get_lib", "library_path"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_REPO_ROOT, "src")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "mxnet_tpu_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmxtpu.so")
_SOURCES = ["recordio.cc", "pipeline.cc", "im2rec.cc"]
_JPEG_SOURCES = ("pipeline.cc", "im2rec.cc")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    return _LIB_PATH


def _compile(srcs, full):
    """One ``g++`` run into a temporary file, moved into place on success."""
    tmp = "%s.tmp-%d" % (_LIB_PATH, os.getpid())
    cmd = (["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp]
           + srcs + (["-ljpeg"] if full else []) + ["-lpthread"])
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _build_locked():
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    newest_src = max((os.path.getmtime(s) for s in srcs
                      if os.path.exists(s)), default=0)
    marker = os.path.join(_BUILD_DIR, ".recordio_only")
    lib_current = (os.path.exists(_LIB_PATH)
                   and os.path.getmtime(_LIB_PATH) >= newest_src)
    if lib_current and not os.path.exists(marker):
        return True
    if _compile(srcs, full=True):
        if os.path.exists(marker):
            os.remove(marker)
        return True
    if lib_current:
        # the full build still fails (no libjpeg) and the RecordIO-only
        # library on disk is current: do not rebuild it in every process
        return True
    recordio_only = [s for s in srcs
                     if os.path.basename(s) not in _JPEG_SOURCES]
    if _compile(recordio_only, full=False):
        open(marker, "w").close()
        return True
    return False


def _build():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "libmxtpu.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "mxtpu_recio_reader_open": (P, [ctypes.c_char_p]),
        "mxtpu_recio_reader_next": (L, [P, ctypes.POINTER(u8p)]),
        "mxtpu_recio_reader_seek": (L, [P, L]),
        "mxtpu_recio_reader_tell": (L, [P]),
        "mxtpu_recio_reader_reset": (None, [P]),
        "mxtpu_recio_reader_close": (None, [P]),
        "mxtpu_recio_writer_open": (P, [ctypes.c_char_p]),
        "mxtpu_recio_writer_write": (L, [P, ctypes.c_char_p, L]),
        "mxtpu_recio_writer_tell": (L, [P]),
        "mxtpu_recio_writer_close": (None, [P]),
        # the threaded decode pipeline and im2rec: absent from the
        # RecordIO-only build
        "mxtpu_pipe_open": (P, [ctypes.c_char_p] + [I] * 6),
        "mxtpu_pipe_next_batch": (L, [P, L, u8p,
                                      ctypes.POINTER(ctypes.c_float)]),
        "mxtpu_pipe_reset": (None, [P]),
        "mxtpu_pipe_skipped": (L, [P]),
        "mxtpu_pipe_read_errors": (L, [P]),
        "mxtpu_pipe_close": (None, [P]),
        "mxtpu_im2rec": (L, [ctypes.c_char_p] * 4 + [I] * 3),
    }
    for name, (restype, argtypes) in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes


def get_lib():
    """The loaded library, or None when ``g++`` cannot build it (the
    callers then read and write RecordIO in Python)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        _bind(lib)
        _lib = lib
        return _lib
