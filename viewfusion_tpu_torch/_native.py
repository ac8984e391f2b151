"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object file, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The library is built at first use into ``_build/`` beside this file
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so
a fresh checkout builds it once and later processes reuse it.

Every C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from viewfusion_tpu_torch import tracing

__all__ = ["library", "check", "build_log", "dtype_code", "stream_ptr",
           "sm_count"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # x, scale, bias, y, mean, rstd, B, L, C, G, then the plan (cluster,
    # rows_per_block, rows_staged, chunk_rows, threads, smem, vec), eps,
    # act, affine_stride, dtype, stream
    "vf_group_norm_act_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # x, g, scale, bias, mean, rstd, dx, dscale_p, dbias_p, B, L, C, G,
    # the plan, act, affine_stride, dtype, stream
    "vf_group_norm_act_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    # cluster, threads, smem, vec, dtype, active (out)
    "vf_group_norm_act_fwd_clusters": [_I, _I, _I, _I, _I, _P],
    "vf_group_norm_act_bwd_clusters": [_I, _I, _I, _I, _I, _P],
    # q, k, v, out, B, S, C, batch_stride, row_stride, scale, parts, dtype,
    # stream
    "vf_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _F, _I, _I,
                         _P],
    # x, g, dw, ws, B, H, W, Cin, Cout, TR, TW, splits, dtype, stream
    "vf_conv3x3_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.iterdir()):  # headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, target: Path) -> str:
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=_BUILD))
    try:
        procs = []
        for src in sources:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log))
        lib_tmp = work / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp),
             *[str(obj) for _, obj, _ in procs], "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}")
        os.replace(lib_tmp, target)  # atomic publish
        return "\n".join(log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call if needed."""
    global _lib, _log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        target = _BUILD / f"libvf_kernels-{_source_key()}.so"
        built = not target.exists()
        with tracing.span("setup.library", built=int(built)):
            if built:
                t0 = time.perf_counter()
                log = _build(sources, target)
                _log = (f"built {target.name} in "
                        f"{time.perf_counter() - t0:.1f} s\n{log}")
            else:
                _log = f"reused {target.name}"
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vf_error_string.argtypes = [ctypes.c_int]
            lib.vf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_log() -> str:
    """What the last :func:`library` call did (nvcc's ptxas report)."""
    return _log


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().vf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh


def dtype_code(dtype, what: str) -> int:
    """The kernels' dtype code for a torch dtype."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    return _DTYPE_CODES[dtype]


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, for a kernel launch."""
    return torch.cuda.current_stream(device).cuda_stream


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of the CUDA ``device`` (cached per device), which
    the wrappers use to size their split reductions."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]
