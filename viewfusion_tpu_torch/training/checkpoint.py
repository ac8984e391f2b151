"""Checkpoints in the JAX package's file format (the port's counterpart of
``viewfusion_tpu/training/checkpoint.py``), so either package resumes,
evaluates and serves the other's run dirs.

A checkpoint file is flax ``msgpack_serialize`` of
``{"state": <state dict>, "extra": <JSON str>}``.  The state dict is the
JAX ``TrainState``'s ``to_state_dict`` tree: ``params`` (``{"params":
{...}}``), ``opt_state`` (optax Adam: ``{"0": {"count", "mu", "nu"},
"1": {"count"}}``), ``step`` (int32, shape ()) and ``ema_params`` (``{}``
without EMA); ``utils/convert.py`` maps the port's ``Trainer`` to and from
it.  The extras are the scalars ``it``, ``t``, ``run_id``, ``ssim`` and
``psnr``.

The msgpack codec below is pure Python and covers what flax writes:
maps, str, bin, ints, floats, bool, nil and lists; ext type 1, an
ndarray whose payload is msgpack ``[shape, dtype name, C-order bytes]``
(ext type 3 is a numpy scalar in the same form); and flax's chunked-array
maps for arrays over :data:`MAX_CHUNK_SIZE` bytes.

Writes are atomic (a temporary file, then a rename).  ``save_async``
takes the device-to-host copy on the caller's CUDA stream before it
returns, so the next step cannot change what is saved; one writer thread
then serialises and writes the files in submission order, and a queued
save is dropped when a newer save to the same file is queued behind it.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Checkpoint", "packb", "unpackb", "MAX_CHUNK_SIZE"]

# flax's limit per array leaf (msgpack's hard limit is 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------
# msgpack
# ----------------------------------------------------------------------
def _head(n: int, fix: Optional[Tuple[int, int]], codes) -> bytes:
    """The header of a str/bin/array/map of length ``n``: a fix form
    (base, limit) when it fits, else the 8/16/32-bit forms in ``codes``
    (None where the family has no such form)."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, ("B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too large")


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _head(n, None, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack("b", v)
    forms = ((0xCC, "B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
             (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64)) \
        if v >= 0 else \
        ((0xD0, "b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
         (0xD2, ">i", -(1 << 31), 0), (0xD3, ">q", -(1 << 63), 0))
    for code, fmt, lo, hi in forms:
        if lo <= v < hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: int {v} is out of range")


def _array_payload_head(a: np.ndarray) -> bytes:
    """msgpack of ``[shape, dtype name, bin]`` up to the bin's bytes."""
    parts = [b"\x93", _head(len(a.shape), (0x90, 16), (None, 0xDC, 0xDD))]
    parts += [_pack_int(int(d)) for d in a.shape]
    name = a.dtype.name.encode()
    parts += [_head(len(name), (0xA0, 32), (0xD9, 0xDA, 0xDB)), name,
              _head(a.nbytes, None, (0xC4, 0xC5, 0xC6))]
    return b"".join(parts)


def _chunked(a: np.ndarray) -> Dict[str, Any]:
    """flax's ``_chunk``: a map of flat pieces of at most
    MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _pack(obj, out: List) -> None:
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        out.append(_pack_int(obj))
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out += [_head(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)), b]
    elif isinstance(obj, (bytes, bytearray)):
        out += [_head(len(obj), None, (0xC4, 0xC5, 0xC6)), bytes(obj)]
    elif isinstance(obj, dict):
        out.append(_head(len(obj), (0x80, 16), (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), (0x90, 16), (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NPSCALAR if isinstance(obj, np.generic) else _EXT_NDARRAY
        a = np.asarray(obj)
        if not a.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
            a = a.copy(order="C")
        if a.dtype.hasobject or a.dtype.names:
            raise ValueError(f"msgpack: cannot write dtype {a.dtype}")
        if code == _EXT_NDARRAY and a.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunked(a), out)
            return
        head = _array_payload_head(a)
        out += [_ext_head(code, len(head) + a.nbytes), head,
                memoryview(a.reshape(-1)).cast("B")]
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj``, as flax ``msgpack_serialize`` writes
    them (numpy arrays and torch tensors become ext 1 ndarrays)."""
    out: List = []
    _pack(obj, out)
    return b"".join(bytes(p) if isinstance(p, memoryview) else p
                    for p in out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: ("B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: ("B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("B"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("B"), fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown ext type {code}")
        if self.unpack("B") != 0x93:
            raise ValueError("msgpack: an ndarray ext is not [shape, dtype, "
                             "bytes]")
        shape = self.value()
        name = self.value()
        if isinstance(name, bytes):
            name = name.decode()
        if name == "bfloat16":
            raise ValueError("msgpack: bfloat16 arrays are not supported")
        b = self.unpack("B")
        lens = {0xC4: "B", 0xC5: ">H", 0xC6: ">I"}
        if b not in lens:
            raise ValueError("msgpack: an ndarray ext holds no bin payload")
        data = self.take(self.unpack(lens[b]))
        if self.pos != end:
            raise ValueError("msgpack: ext length does not match its "
                             "payload")
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(obj):
    if isinstance(obj, dict):
        if _CHUNKED in obj:
            shape = tuple(obj["shape"][str(i)]
                          for i in range(len(obj["shape"])))
            chunks = [obj["chunks"][str(i)]
                      for i in range(len(obj["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in obj.items()}
    return obj


def unpackb(data) -> Any:
    """Decode msgpack bytes as flax ``msgpack_restore`` does (arrays are
    read-only views of ``data``)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes after the object")
    return _unchunk(out)


# ----------------------------------------------------------------------
# Checkpoint
# ----------------------------------------------------------------------
def _host_snapshot(tree) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """Host copies of every tensor in ``tree``: CUDA tensors into pinned
    memory by copies queued on the current stream (returned with an
    event that completes after them), CPU tensors and arrays copied
    now."""
    event = None

    def walk(x):
        nonlocal event
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                if event is None:
                    event = torch.cuda.Event()
                return host
            return x.clone()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    out = walk(tree)
    if event is not None:
        event.record()
    return out, event


class Checkpoint:
    """Run-dir checkpoints (see the module docstring).  Creating one for
    a new directory makes it and writes ``config_yaml`` there as
    ``config.yaml``.  With more than one process only the rank built with
    ``is_host0`` makes the directory and writes; the others' saves return
    at once.  The state they are given must already be whole: the
    caller gathers a partitioned state on every rank first (under ZeRO-1,
    ``trainer_state_to_jax``), or the ranks deadlock."""

    def __init__(self, checkpoint_dir: str,
                 config_yaml: Optional[str] = None, is_host0: bool = True):
        self.checkpoint_dir = checkpoint_dir
        self.is_host0 = is_host0
        if is_host0 and not os.path.exists(checkpoint_dir):
            os.makedirs(checkpoint_dir, exist_ok=True)
            if config_yaml is not None:
                with open(os.path.join(checkpoint_dir, "config.yaml"),
                          "w") as f:
                    f.write(config_yaml)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        self._seq = 0
        self._latest_seq: Dict[str, int] = {}
        # the queued item per path, so a newer save drops its snapshot
        self._pending: Dict[str, list] = {}
        self._lock = threading.Lock()
        # top-level template fields the last load() did not find
        self.last_missing: List[str] = []

    def _path(self, filename: str) -> str:
        if not os.path.isabs(filename):
            filename = os.path.join(self.checkpoint_dir, filename)
        return filename

    @staticmethod
    def _write(path: str, state: Any, extra: Dict[str, Any]) -> None:
        parts: List = []
        _pack({"state": state, "extra": json.dumps(extra)}, parts)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            for p in parts:
                f.write(p)
        os.replace(tmp, path)

    def save(self, filename: str, state: Any, **extra: Any) -> None:
        """Write ``state`` (a nested dict of tensors and arrays) and the
        scalar extras; returns when the file is on disk.  Queued async
        saves are written first, so an older one never lands on top."""
        if not self.is_host0:
            return
        if self._queue is not None:
            self.flush()
        self._raise_worker_error()
        self._write(self._path(filename), state, extra)

    def save_async(self, filename: str, state: Any, **extra: Any) -> None:
        """Like :meth:`save`, but returns once the host copies are queued
        on the caller's stream; the writer thread waits for them, then
        serialises and writes."""
        if not self.is_host0:
            return
        self._raise_worker_error()
        snap, event = _host_snapshot(state)
        if self._queue is None:
            self._queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name="checkpoint-writer")
            self._worker.start()
        path = self._path(filename)
        with self._lock:
            self._seq += 1
            item = [self._seq, path, snap, event, extra]
            self._latest_seq[path] = self._seq
            old = self._pending.get(path)
            if old is not None:
                old[2] = old[3] = None  # superseded: free its host copy
            self._pending[path] = item
        self._queue.put(item)

    def _worker_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                seq, path, snap, event, extra = item
                with self._lock:
                    superseded = self._latest_seq.get(path, seq) > seq
                    if self._pending.get(path) is item:
                        del self._pending[path]
                if superseded:
                    continue
                if event is not None:
                    event.synchronize()
                item[2] = item[3] = None
                self._write(path, snap, extra)
            except BaseException as e:  # noqa: BLE001 — raised on flush
                self._worker_error = e
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Block until every queued save is on disk; re-raise the first
        failure of the writer."""
        if self._queue is not None:
            self._queue.join()
        self._raise_worker_error()

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise RuntimeError("async checkpoint save failed") from err

    def load(self, filename: str,
             template: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                                Dict[str, Any]]:
        """Read a checkpoint: returns (state, extras), where ``state`` has
        the top-level fields of ``template``; a field the file lacks keeps
        the template's value (a params-only file, or one without
        ``ema_params``) and is listed in ``last_missing``."""
        self.flush()  # a resume must see the queued saves
        with open(self._path(filename), "rb") as f:
            payload = unpackb(f.read())
        saved = payload["state"]
        if not isinstance(saved, dict):
            raise ValueError(f"{filename}: the state is not a mapping")
        missing = sorted(set(template) - set(saved))
        if missing:
            print(f"Checkpoint {filename} lacks {missing}; keeping fresh "
                  "values for them.")
        self.last_missing = missing
        state = {k: saved[k] if k in saved else template[k]
                 for k in template}
        return state, json.loads(payload["extra"])

    def exists(self, filename: str) -> bool:
        return os.path.exists(self._path(filename))
