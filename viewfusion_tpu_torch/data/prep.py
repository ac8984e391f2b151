"""Offline NMR dataset sharder: NMR_Dataset.zip -> webdataset tar shards
(the port's counterpart of ``viewfusion_tpu/data/prep.py``).

    python -m viewfusion_tpu_torch.data.prep -s ./data/nmr -d ./data/nmr

The shards are byte-identical to the JAX sharder's, which match the
reference tooling's (data/dataset_prep.py): destination dir
``NMR_sharded[_withheld]_{pct}_{n}``, shard names ``NMR-{split}-{NN}.tar``,
per-scene sample keys ``{category}-{scene}`` holding ``0000.png ..
0023.png`` + ``cameras`` (npz bytes, passed through untouched), per-shard
capacity ``round(pct/100 * total) // shard_count`` with the overflow-shard
warning.  ``--withhold`` drops categories by their human name; ``--raw``
also writes the pre-decoded ``.rec`` twins (``data/rawrec.py``).

``metadata.yaml`` is read with the port's own YAML reader
(:func:`viewfusion_tpu_torch.config.parse_yaml`), which resolves scalars
as ``yaml.safe_load`` does: an unquoted category id made only of the
digits 0-7 after its leading zero (``03001627``) is an octal int there
too, and the id is used as that value.
"""

from __future__ import annotations

import argparse
import os
import warnings
import zipfile
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

from viewfusion_tpu_torch.config import parse_yaml
from viewfusion_tpu_torch.data.tario import TarShardWriter

__all__ = ["ZipCatalog", "ShardRotator", "get_dataset_size",
           "shard_dataset", "main"]

SPLITS = ("train", "val", "test")


@dataclass(frozen=True)
class Scene:
    category: str   # zip category id, e.g. "02691156"
    name: str       # scene dir name

    @property
    def key(self) -> str:
        return f"{self.category}-{self.name}"

    @property
    def path(self) -> str:
        return f"NMR_Dataset/{self.category}/{self.name}"


class ZipCatalog:
    """All access to NMR_Dataset.zip: category metadata, split listings
    and per-scene payload reads."""

    def __init__(self, src_dir: str, withheld: Sequence[str] = ()):
        self._zip = zipfile.ZipFile(os.path.join(src_dir, "NMR_Dataset.zip"))
        meta = parse_yaml(
            self._zip.read("NMR_Dataset/metadata.yaml").decode("utf-8-sig"))
        excluded = set(withheld)
        # categories in metadata order, minus withheld human names
        self.categories: List[Tuple[str, str]] = [
            (cat_id, info["name"]) for cat_id, info in meta.items()
            if info["name"] not in excluded]

    def scenes(self, category: str, split: str) -> Iterator[Scene]:
        listing = self._zip.read(f"NMR_Dataset/{category}/{split}.lst").split()
        for raw in listing:
            yield Scene(category, raw.decode("utf-8"))

    def iter_split(self, split: str) -> Iterator[Scene]:
        for cat_id, _ in self.categories:
            yield from self.scenes(cat_id, split)

    def scene_counts(self, split: str) -> Dict[str, int]:
        return {cat_id: sum(1 for _ in self.scenes(cat_id, split))
                for cat_id, _ in self.categories}

    def read_sample(self, scene: Scene,
                    views_per_scene: int = 24) -> Dict[str, bytes]:
        """One webdataset sample: the scene's view PNGs and camera npz,
        bytes untouched (the shards round-trip the source pixels)."""
        sample: Dict[str, object] = {"__key__": scene.key}
        for i in range(views_per_scene):
            fname = f"{i:04d}.png"
            sample[fname] = self._zip.read(f"{scene.path}/image/{fname}")
        sample["cameras"] = self._zip.read(f"{scene.path}/cameras.npz")
        return sample


class ShardRotator:
    """Write samples across ``NMR-{split}-{NN}.tar`` files, rotating every
    ``capacity`` samples; warns when data overflows past the planned
    shard count (the reference writer loop's contract)."""

    def __init__(self, dest_dir: str, split: str, capacity: int,
                 planned_shards: int):
        self.dest_dir = dest_dir
        self.split = split
        # capacity 0 never rotates (everything lands in shard 00): the
        # reference's `sample_no == limit` with limit 0 never fires
        # (dataset_prep.py:95), e.g. tiny --percent runs
        self.capacity = capacity
        self.planned = planned_shards
        self._idx = 0
        self._in_shard = 0
        self._sink = self._open(0)

    def _open(self, idx: int) -> TarShardWriter:
        return TarShardWriter(
            os.path.join(self.dest_dir, f"NMR-{self.split}-{idx:02d}.tar"))

    def write(self, sample: Dict[str, bytes]) -> None:
        self._sink.write(sample)
        self._in_shard += 1
        if self.capacity > 0 and self._in_shard >= self.capacity:
            self._sink.close()
            self._idx += 1
            self._in_shard = 0
            self._sink = self._open(self._idx)
            if self._idx >= self.planned:
                warnings.warn(
                    "Number of dataset samples not divisible by shard "
                    "count; overflowing into an extra uneven shard.")

    def write_all(self, samples: Iterable[Dict[str, bytes]]) -> None:
        try:
            for sample in samples:
                self.write(sample)
        finally:
            self._sink.close()


def get_dataset_size(src_dir: str, withheld: Sequence[str] = ()
                     ) -> Dict[str, Dict[str, int]]:
    """Per-split, per-category scene counts (printed, as the reference
    CLI does, data/dataset_prep.py:21-42)."""
    catalog = ZipCatalog(src_dir, withheld)
    sizes: Dict[str, Dict[str, int]] = {}
    names = dict(catalog.categories)
    for split in SPLITS:
        counts = catalog.scene_counts(split)
        for cat_id, cnt in counts.items():
            print(f"{names[cat_id]}: {cnt}")
        sizes[split] = counts
    return sizes


def shard_dataset(src_dir: str, size_dict: Dict[str, Dict[str, int]],
                  dest_dir: str, split: str = "test", percent: int = 100,
                  shard_cnt: int = 4, withheld: Sequence[str] = (),
                  views_per_scene: int = 24) -> str:
    """Write one split's shards; returns the destination directory."""
    flavor = "NMR_sharded_withheld" if withheld else "NMR_sharded"
    dest_dir = os.path.join(dest_dir, f"{flavor}_{percent}_{shard_cnt}")
    os.makedirs(dest_dir, exist_ok=True)
    total = sum(size_dict[split].values())
    capacity = round(percent / 100 * total) // shard_cnt
    catalog = ZipCatalog(src_dir, withheld)
    samples = (catalog.read_sample(scene, views_per_scene)
               for scene in catalog.iter_split(split))
    ShardRotator(dest_dir, split, capacity, shard_cnt).write_all(samples)
    return dest_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m viewfusion_tpu_torch.data.prep")
    parser.add_argument("-s", "--src_dir", type=str, default="./data/nmr")
    parser.add_argument("-d", "--dest_dir", type=str, default="./data/nmr")
    parser.add_argument("-pc", "--percent", type=int, default=100)
    parser.add_argument("-sc", "--shard_count", type=int, default=4)
    parser.add_argument("--withhold", nargs="*", default=[])
    parser.add_argument(
        "--raw", action="store_true",
        help="also write pre-decoded .rec twins next to the tar shards "
             "(decode once at prep time; see data/rawrec.py)")
    args = parser.parse_args(argv)
    size_dict = get_dataset_size(args.src_dir, args.withhold)
    for split in SPLITS:
        dest = shard_dataset(args.src_dir, size_dict, args.dest_dir, split,
                             args.percent, args.shard_count, args.withhold)
    if args.raw:
        from viewfusion_tpu_torch.data.rawrec import convert_shard_dir

        for path in convert_shard_dir(dest):
            print(f"raw shard: {path}")


if __name__ == "__main__":
    main()
