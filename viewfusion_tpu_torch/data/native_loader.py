"""ctypes binding of the native C++ shard loader (``native/vfloader.cpp``;
the port's counterpart of ``viewfusion_tpu/data/native_loader.py``).

Tar streaming and PNG decode run in C++ worker threads, off the GIL;
per-sample processing stays in numpy.  The library is built at first
use, with the flags of ``native/build.sh``, into ``_build/`` beside this
package (listed in ``.gitignore``; ``native/`` is never written), named
by a hash of the source and flags so that a changed source builds anew.
The build is tried at most once per process and serialised across
processes by a lock file; :func:`build_error` keeps the compiler's
message when it fails.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["NativeShardReader", "native_available", "require_native",
           "build_error", "lib_path"]

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "vfloader.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]
_LIBS = ["-lz", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_tried = False


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    h.update(_SOURCE.read_bytes() if _SOURCE.exists() else b"")
    return _BUILD / f"libvfloader-{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    if not _SOURCE.exists():
        raise RuntimeError(f"{_SOURCE} is missing")
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / "vfloader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released on close
        if target.exists():
            return  # another process built it while this one waited
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run(
            [cxx, *_FLAGS, str(_SOURCE), *_LIBS, "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed (exit {proc.returncode}):\n"
                               f"{proc.stdout.strip()}")
        os.replace(tmp, target)  # atomic publish


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.vf_loader_open.restype = ctypes.c_void_p
    lib.vf_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.vf_loader_next.restype = ctypes.c_int
    lib.vf_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.vf_loader_release.argtypes = [ctypes.c_void_p]
    lib.vf_loader_release.restype = None
    lib.vf_loader_decode_errors.restype = ctypes.c_long
    lib.vf_loader_decode_errors.argtypes = [ctypes.c_void_p]
    lib.vf_loader_close.argtypes = [ctypes.c_void_p]
    lib.vf_loader_close.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                target = lib_path()
                if not target.exists():
                    _compile(target)
                _lib = _bind(target)
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _error = str(e)
        return _lib


def native_available() -> bool:
    """Whether the native library is built (building it if need be)."""
    return _load() is not None


def require_native() -> ctypes.CDLL:
    """The library, or a RuntimeError with the build's message."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native loader did not build: {_error}")
    return lib


def build_error() -> Optional[str]:
    """Why the library did not build (None if it built or was not
    tried)."""
    return _error


class NativeShardReader:
    """Iterates (views uint8 NHWC (V, H, W, 3), key) decoded by C++
    threads.  Raises FileNotFoundError up front for missing shards and
    RuntimeError if the stream produces no readable samples.  Sample
    order is the threads' completion order, not reproducible across
    runs; the downstream shuffle buffer mixes it either way."""

    def __init__(self, urls: List[str], total_views: int = 24,
                 n_threads: int = 4, resample: bool = True, seed: int = 0,
                 capacity: int = 64):
        missing = [u for u in urls if not os.path.exists(u)]
        if missing:
            raise FileNotFoundError(f"missing shard(s): {missing}")
        self._lib = require_native()
        self._names = (ctypes.c_char_p * len(urls))(
            *[u.encode() for u in urls])
        self._handle = self._lib.vf_loader_open(
            self._names, len(urls), n_threads, total_views, int(resample),
            seed, capacity)
        if not self._handle:
            raise RuntimeError("vf_loader_open failed (empty shard list?)")
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[np.ndarray, str]]:
        data_p = ctypes.POINTER(ctypes.c_uint8)()
        views, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        key = ctypes.create_string_buffer(512)
        token = ctypes.c_void_p()
        yielded = 0
        while True:
            if self._closed:
                raise RuntimeError("NativeShardReader is closed")
            rc = self._lib.vf_loader_next(
                self._handle, ctypes.byref(data_p), ctypes.byref(views),
                ctypes.byref(h), ctypes.byref(w), key, len(key),
                ctypes.byref(token))
            if rc <= 0:
                if rc < 0 or (yielded == 0 and self.decode_errors > 0):
                    raise RuntimeError(
                        "native loader produced no readable samples "
                        f"({self.decode_errors} shard/decode errors)")
                return
            n = views.value * h.value * w.value * 3
            out = np.ctypeslib.as_array(data_p, shape=(n,)).copy().reshape(
                views.value, h.value, w.value, 3)
            self._lib.vf_loader_release(token)
            yielded += 1
            yield out, key.value.decode()

    @property
    def decode_errors(self) -> int:
        return int(self._lib.vf_loader_decode_errors(self._handle))

    def close(self) -> None:
        if not self._closed:
            self._lib.vf_loader_close(self._handle)
            self._closed = True

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
