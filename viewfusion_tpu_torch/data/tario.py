"""WebDataset-format tar shard reader/writer on the stdlib (the port's
copy of ``viewfusion_tpu/data/tario.py``).

Samples are groups of files sharing a basename prefix (key = prefix), the
on-disk format of the reference's shards (``webdataset``'s tar streaming
and ``wds.TarWriter``), so either package reads the other's shards.  The
multi-threaded C++ reader of ``native/`` has the same iterator contract
(:mod:`viewfusion_tpu_torch.data.native_loader`).
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Dict, Iterator, List

__all__ = ["iter_tar_samples", "TarShardWriter", "expand_shard_urls"]


def iter_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Yield webdataset-style samples from one tar shard.

    Each sample is {"__key__": str, "<suffix>": bytes, ...}; files are
    grouped by basename prefix (everything before the first dot), in
    archive order — the same grouping webdataset uses.
    """
    with tarfile.open(path, "r|*") as tf:
        current_key = None
        sample: Dict[str, bytes] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            base = os.path.basename(name)
            if "." in base:
                prefix, suffix = base.split(".", 1)
            else:
                prefix, suffix = base, ""
            key = os.path.join(os.path.dirname(name), prefix)
            if current_key is not None and key != current_key:
                yield sample
                sample = {}
            current_key = key
            sample["__key__"] = key
            fobj = tf.extractfile(member)
            if fobj is not None:
                sample[suffix] = fobj.read()
        if current_key is not None and sample:
            yield sample


class TarShardWriter:
    """Minimal wds.TarWriter equivalent (raw-bytes mode, encoder=False,
    matching data/dataset_prep.py:79-84)."""

    def __init__(self, path: str):
        self._tf = tarfile.open(path, "w")

    def write(self, sample: Dict[str, bytes]) -> None:
        key = sample["__key__"]
        for suffix, payload in sample.items():
            if suffix == "__key__":
                continue
            if not isinstance(payload, (bytes, bytearray)):
                raise TypeError(
                    f"TarShardWriter is raw-bytes only; got {type(payload)} "
                    f"for {key}.{suffix}"
                )
            info = tarfile.TarInfo(name=f"{key}.{suffix}")
            info.size = len(payload)
            self._tf.addfile(info, io.BytesIO(bytes(payload)))

    def close(self) -> None:
        self._tf.close()

    def __enter__(self) -> "TarShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def expand_shard_urls(
    path: str, mode: str, start_shard: int, end_shard: int
) -> List[str]:
    """Expand the reference's brace-notation shard pattern
    ``NMR-{mode}-{SS..EE}.tar`` (data/nmr_dataset.py:72-94) to paths."""
    return [
        os.path.join(path, f"NMR-{mode}-{i:02d}.tar")
        for i in range(start_shard, end_shard + 1)
    ]
