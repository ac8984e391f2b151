"""Pre-decoded raw record shards (the port's copy of
``viewfusion_tpu/data/rawrec.py``; the same file format, so either
package reads the other's shards).

A PNG tar shard costs a PNG decode per view per sample at train time
(672 decodes per batch-28 step).  The `.rec` twin of a shard stores the
decoded uint8 pixels once, at prep time:

    NMR-{split}-{NN}.rec
    ┌──────────────────────────────────────────────────────────┐
    │ magic  b"VFREC001"                             8 bytes   │
    │ V, H, W, C, count            little-endian uint32 ×5     │
    │ count × (V·H·W·C) uint8 records  (one object each)       │
    │ key table: "\n".join(keys) utf-8                         │
    │ key-table offset                 little-endian uint64    │
    └──────────────────────────────────────────────────────────┘

Fixed-size records + a tail offset give O(1) random access to any
object via mmap — reads are zero-copy slices, there is no decode, and a
train pass can visit records in any order for free.  The tar format
remains the interchange format (byte-compatible with reference
tooling); `.rec` is derived data, reproducible from the tars with
``python -m viewfusion_tpu_torch.data.rawrec <shard-dir>``.  Camera npz blobs
are not carried over: no runtime path consumes them (angles are derived
from view indices, data/nmr_dataset.py:20-24).

Readers yield ``(views_u8 (V,H,W,3), key)`` — the same iterator
contract as the native C++ tar reader (``data/native_loader.py``), so
``NMRStream`` treats the two interchangeably.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "RawShardWriter", "RawShardReader", "read_raw_header",
    "convert_tar_shard", "convert_shard_dir", "raw_twin", "main",
]

MAGIC = b"VFREC001"
_HEADER = struct.Struct("<5I")  # V, H, W, C, count


def raw_twin(tar_path: str) -> str:
    """`.rec` path corresponding to a `.tar` shard path."""
    base, _ = os.path.splitext(tar_path)
    return base + ".rec"


class RawShardWriter:
    """Stream (views_u8, key) records into one `.rec` shard.

    Record geometry is fixed by the first write; the file is built at a
    temp name and moved into place on close so concurrent readers never
    observe a partial shard (same discipline as the checkpoint writer).
    """

    def __init__(self, path: str):
        self.path = path
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._keys: List[str] = []
        self._shape: Optional[Tuple[int, int, int, int]] = None

    def write(self, views: np.ndarray, key: str) -> None:
        views = np.ascontiguousarray(views)
        if views.dtype != np.uint8 or views.ndim != 4:
            raise TypeError(
                f"RawShardWriter wants (V,H,W,C) uint8; got "
                f"{views.dtype} {views.shape}"
            )
        if self._shape is None:
            self._shape = views.shape
            self._f.write(MAGIC)
            self._f.write(_HEADER.pack(*views.shape, 0))
        elif views.shape != self._shape:
            raise ValueError(
                f"record shape {views.shape} != shard shape {self._shape}"
            )
        if "\n" in key:
            raise ValueError(f"keys must not contain newlines: {key!r}")
        self._f.write(views.tobytes())
        self._keys.append(key)

    def close(self) -> None:
        if self._f.closed:
            return
        if self._shape is None:
            # Empty shard: header with zero geometry.
            self._f.write(MAGIC)
            self._f.write(_HEADER.pack(0, 0, 0, 0, 0))
        table_off = self._f.tell()
        self._f.write("\n".join(self._keys).encode("utf-8"))
        self._f.write(struct.pack("<Q", table_off))
        # Patch the record count into the header.
        self._f.seek(len(MAGIC) + _HEADER.size - 4)
        self._f.write(struct.pack("<I", len(self._keys)))
        self._f.close()
        os.replace(self._tmp, self.path)

    def __enter__(self) -> "RawShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self._f.close()
            os.unlink(self._tmp)
        else:
            self.close()


def read_raw_header(path: str) -> Tuple[Tuple[int, int, int, int], int]:
    """((V, H, W, C), record_count) of a `.rec` shard."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a VFREC001 raw shard")
        v, h, w, c, n = _HEADER.unpack(f.read(_HEADER.size))
    return (v, h, w, c), n


class _Shard:
    """One mmapped `.rec` file: O(1) record access, zero-copy views."""

    def __init__(self, path: str):
        self.path = path
        (self.shape, self.count) = read_raw_header(path)
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.rec_size = int(np.prod(self.shape))
        self._base = len(MAGIC) + _HEADER.size
        (table_off,) = struct.unpack("<Q", self._mm[-8:])
        table = self._mm[table_off : len(self._mm) - 8]
        self.keys = table.decode("utf-8").split("\n") if table else []
        if len(self.keys) != self.count:
            raise ValueError(
                f"{path}: key table has {len(self.keys)} entries for "
                f"{self.count} records (truncated shard?)"
            )

    def record(self, i: int) -> np.ndarray:
        off = self._base + i * self.rec_size
        return np.frombuffer(
            self._mm, dtype=np.uint8, count=self.rec_size, offset=off
        ).reshape(self.shape)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # Zero-copy record views are still live downstream (e.g. in
            # a shuffle buffer); the read-only mapping is released by GC
            # when the last view drops.
            pass
        self._f.close()


class RawShardReader:
    """Iterate (views_u8, key) over `.rec` shards.

    Same contract as the native tar reader: infinite when
    ``resample=True``, shard order reshuffled per pass.  Because records
    are randomly addressable, ``shuffle=True`` (train) also permutes the
    record order *within* each shard per pass — strictly more mixing
    than the tar readers' archive-order streams can offer for the same
    shuffle-buffer budget.
    """

    def __init__(self, paths: Sequence[str], resample: bool = True,
                 seed: int = 0, shuffle: bool = True):
        self.paths = list(paths)
        self.resample = resample
        self.shuffle = shuffle
        self.rng = np.random.default_rng(np.random.SeedSequence([seed]))
        self._shards: Dict[str, _Shard] = {}

    def _shard(self, path: str) -> _Shard:
        if path not in self._shards:
            self._shards[path] = _Shard(path)
        return self._shards[path]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, str]]:
        while True:
            order = list(self.paths)
            if self.shuffle:
                self.rng.shuffle(order)
            for path in order:
                shard = self._shard(path)
                idx = np.arange(shard.count)
                if self.shuffle:
                    self.rng.shuffle(idx)
                for i in idx:
                    yield shard.record(int(i)), shard.keys[int(i)]
            if not self.resample:
                return

    def close(self) -> None:
        for shard in self._shards.values():
            shard.close()
        self._shards.clear()


def convert_tar_shard(tar_path: str, rec_path: Optional[str] = None,
                      total_views: int = 24) -> str:
    """Decode one PNG tar shard into its `.rec` twin; returns the path."""
    from viewfusion_tpu_torch.data.nmr import decode_views_u8
    from viewfusion_tpu_torch.data.tario import iter_tar_samples

    rec_path = rec_path or raw_twin(tar_path)
    with RawShardWriter(rec_path) as sink:
        for sample in iter_tar_samples(tar_path):
            sink.write(decode_views_u8(sample, total_views),
                       sample["__key__"])
    return rec_path


def convert_shard_dir(shard_dir: str, total_views: int = 24,
                      force: bool = False) -> List[str]:
    """Convert every ``NMR-*-NN.tar`` in a directory that lacks an
    up-to-date `.rec` twin."""
    out = []
    for name in sorted(os.listdir(shard_dir)):
        if not (name.startswith("NMR-") and name.endswith(".tar")):
            continue
        tar_path = os.path.join(shard_dir, name)
        rec_path = raw_twin(tar_path)
        if (not force and os.path.exists(rec_path)
                and os.path.getmtime(rec_path) >= os.path.getmtime(tar_path)):
            out.append(rec_path)
            continue
        out.append(convert_tar_shard(tar_path, rec_path, total_views))
    return out


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Convert NMR PNG tar shards to pre-decoded .rec shards"
    )
    p.add_argument("shard_dir")
    p.add_argument("--total-views", type=int, default=24)
    p.add_argument("--force", action="store_true",
                   help="rebuild .rec twins even if newer than the tar")
    args = p.parse_args(argv)
    for path in convert_shard_dir(args.shard_dir, args.total_views,
                                  args.force):
        shape, n = read_raw_header(path)
        print(f"{path}: {n} records of {shape}")


if __name__ == "__main__":
    main()
