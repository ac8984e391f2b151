"""NMR ShapeNet input pipeline (the port's copy of
``viewfusion_tpu/data/nmr.py``): decode, per-sample processing, the
infinite sharded stream with its shuffle buffer, batching and background
prefetch.  Everything is numpy seeded from ``seed``, so for the same
shards and arguments the batches equal the JAX stream's bit for bit.

  * ``process_sample``: a random view permutation; target = the first
    shuffled view, cond = the remaining 23; absolute angle 2*pi/24*idx0;
    a 10% train-time re-shuffle that may leak the target into cond; the
    relative-conditioning variant with the reference view concatenated
    on the channels and the relative angle.  Images stay in [0, 1].
  * the stream: resampled shards in a shuffled order, a 1000-sample
    shuffle buffer, the per-host shard split ``urls[host::num_hosts]``.
  * the reader of decoded views: the pre-decoded `.rec` twins when every
    shard has one, else the native C++ loader when it builds, else the
    port's image codecs (``utils/image.py:decode_image``;
    ``NMRStream.reader`` says which ran).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from viewfusion_tpu_torch.config import SplitConfig
from viewfusion_tpu_torch.data.tario import expand_shard_urls, iter_tar_samples
from viewfusion_tpu_torch.data.native_loader import (NativeShardReader,
                                                     native_available,
                                                     require_native)
from viewfusion_tpu_torch.data.rawrec import RawShardReader, raw_twin
from viewfusion_tpu_torch.utils.image import decode_image

__all__ = ["process_sample", "decode_views", "NMRStream", "create_nmr_stream",
           "Batcher", "prefetch"]

TOTAL_VIEWS = 24  # views per object in NMR ShapeNet (data/nmr_dataset.py:11)


def decode_views_u8(sample: Dict[str, bytes],
                    total_views: int = TOTAL_VIEWS) -> np.ndarray:
    """Decode the ``0000.png .. 0023.png`` views of one sample to
    (V, H, W, 3) uint8 (through the port's codecs, which read a view by
    its content as PIL's ``Image.open`` does, equal to its
    ``convert("RGB")``)."""
    return np.stack([decode_image(sample[f"{i:04d}.png"])
                     for i in range(total_views)], 0)


def decode_views(sample: Dict[str, bytes],
                 total_views: int = TOTAL_VIEWS) -> np.ndarray:
    """(V, H, W, 3) float32 in [0, 1] (webdataset ``.decode("rgb")``
    equivalent, data/nmr_dataset.py:97)."""
    return decode_views_u8(sample, total_views).astype(np.float32) / 255.0


def process_sample(
    images: np.ndarray,
    key: str,
    mode: str,
    rng: np.random.Generator,
    relative: bool = False,
    needed: Optional[frozenset] = None,
    n_cond_views: Optional[int] = None,
    out_dtype: type = np.float32,
) -> Dict[str, np.ndarray]:
    """Reference ``process_sample`` semantics (data/nmr_dataset.py:10-52),
    NHWC.  ``images`` is (24, H, W, 3), float32 in [0, 1] or uint8
    (converted lazily — only the views a requested key touches).

    The permutation/leak logic runs in *index space* so nothing is
    materialized for keys the consumer doesn't ask for: ``needed`` (None
    = every key) and ``n_cond_views`` (None = all 23) let the trainer
    skip the float conversion of 24 views per sample when it only feeds
    target + max_views cond views.  RNG draw order is identical in every
    configuration, so a stream produces the same samples whatever subset
    is requested (pinned by tests/test_data.py).
    """
    v = images.shape[0]
    # ``out_dtype=np.uint8`` keeps image payloads uint8 (consumer
    # normalizes on device, tpu.u8_feed); float input stays float.
    if images.dtype == np.uint8 and out_dtype is not np.uint8:
        to_f32 = lambda x: np.asarray(x, np.float32) / np.float32(255.0)  # noqa: E731
    else:
        to_f32 = np.asarray
    images_idx = np.arange(v)
    rng.shuffle(images_idx)
    # Reference: cond_images = images[perm]; target = cond_images[0].
    order = images_idx.copy()
    target_idx = order[0]
    angle = np.float32(2 * np.pi / v * target_idx)

    # 10% of train samples re-shuffle so the target may leak into cond
    # (data/nmr_dataset.py:27-29).  The reference re-indexes the already
    # permuted stack — composition order[perm2] — and its relative_angle
    # then reads the *positional* indices perm2, a quirk kept as-is.
    if mode == "train" and rng.random() < 0.1:
        rng.shuffle(images_idx)
        order = order[images_idx]

    relative_angle = np.float32(
        2 * np.pi / v * (images_idx[1] - images_idx[0])
    )

    cond_idx = order[1:]
    if n_cond_views is not None:
        cond_idx = cond_idx[:n_cond_views]

    want = lambda k: needed is None or k in needed  # noqa: E731
    result: Dict[str, np.ndarray] = {
        "angle": angle,
        "relative_angle": relative_angle,
        "scene_hash": key,
    }
    if want("target"):
        result["target"] = to_f32(images[target_idx])
    cond = to_f32(images[cond_idx]) if (
        want("cond") or (relative and want("relative_cond"))
    ) else None
    if want("cond"):
        result["cond"] = cond
    if want("all_views"):
        result["all_views"] = to_f32(images)
    if relative and want("relative_cond"):
        ref = np.broadcast_to(to_f32(images[order[1]])[None], cond.shape)
        result["relative_cond"] = np.concatenate((ref, cond), axis=-1)
    return result


class NMRStream:
    """Infinite (or single-pass) stream of processed NMR samples."""

    def __init__(
        self,
        urls: List[str],
        mode: str,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        resample: bool = True,
        relative: bool = False,
        total_views: int = TOTAL_VIEWS,
        native: Optional[bool] = None,
        native_threads: int = 4,
        data_format: str = "auto",
        needed_keys: Optional[Sequence[str]] = None,
        n_cond_views: Optional[int] = None,
        out_dtype: type = np.float32,
        process_mode: Optional[str] = None,
    ):
        if num_hosts > 1:
            if len(urls) % num_hosts != 0:
                # reference asserts shard_count % world_size == 0
                # (data/nmr_dataset.py:65-70)
                raise ValueError(
                    "Shard count must be divisible by the number of hosts"
                )
            urls = urls[host_id::num_hosts]
        self.urls = urls
        self.mode = mode
        # mode names the shard files (NMR-{mode}-NN.tar); process_mode
        # overrides the per-sample SEMANTICS — e.g. evaluating on the
        # train shards without the 10% target-leak augmentation
        # (tpu.eval_train_split).  None = same as mode.
        self.process_mode = process_mode or mode
        self.shuffle_buffer = shuffle_buffer if mode == "train" else 0
        self.resample = resample
        self.relative = relative
        self.total_views = total_views
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, host_id])
        )
        self.seed = seed
        self.native_threads = native_threads
        # Materialize only the keys/views the consumer feeds to the
        # model (None = everything); RNG parity across subsets is pinned
        # by tests.
        self.needed_keys = (
            None if needed_keys is None else frozenset(needed_keys)
        )
        self.n_cond_views = n_cond_views
        self.out_dtype = out_dtype
        # Pre-decoded raw shards (data/rawrec.py) skip PNG decode
        # entirely: "auto" uses the `.rec` twin when every shard has
        # one, "raw" requires it, "tar" forces the PNG path.
        if data_format not in ("auto", "raw", "tar"):
            raise ValueError(f"data_format must be auto/raw/tar, "
                             f"got {data_format!r}")
        twins = [raw_twin(u) for u in self.urls]
        have_twins = all(os.path.exists(t) for t in twins)
        if data_format == "raw" and not have_twins:
            missing = [t for t in twins if not os.path.exists(t)]
            raise FileNotFoundError(
                f"data_format=raw but .rec shards are missing "
                f"(first: {missing[0]}); build them with "
                f"`python -m viewfusion_tpu_torch.data.rawrec <shard-dir>`"
            )
        self.raw = data_format in ("auto", "raw") and have_twins
        self.raw_urls = twins if self.raw else []
        # tpu.native_loader: True requires the native library (a failed
        # build raises with the compiler's message), None uses it when
        # it builds, False never
        if self.raw:
            native = False
        elif native:
            require_native()
        elif native is None:
            native = native_available()
        self.native = bool(native)
        self.reader = ("rawrec" if self.raw else
                       "native" if self.native else "codec")

    def _iter_raw(self) -> Iterator[Dict[str, bytes]]:
        while True:
            order = list(self.urls)
            self.rng.shuffle(order)  # shardshuffle=True
            for url in order:
                yield from iter_tar_samples(url)
            if not self.resample:
                return

    def _iter_decoded(self) -> Iterator:
        """Yield (views uint8 NHWC, key) from ``self.reader``; uint8 keeps
        the shuffle buffer 4x smaller than float."""
        if self.raw:
            reader = RawShardReader(
                self.raw_urls, resample=self.resample, seed=self.seed,
                shuffle=self.mode == "train",
            )
            try:
                yield from reader
            finally:
                reader.close()
            return
        if self.native:
            reader = NativeShardReader(
                self.urls, total_views=self.total_views,
                n_threads=self.native_threads, resample=self.resample,
                seed=self.seed,
            )
            try:
                yield from reader
            finally:
                reader.close()
            return
        for raw in self._iter_raw():
            yield decode_views_u8(raw, self.total_views), raw["__key__"]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf: List = []

        def process(item):
            images, key = item
            return process_sample(
                images, key, self.process_mode, self.rng, self.relative,
                needed=self.needed_keys, n_cond_views=self.n_cond_views,
                out_dtype=self.out_dtype,
            )

        for raw in self._iter_decoded():
            if self.shuffle_buffer <= 1:
                yield process(raw)
                continue
            buf.append(raw)
            if len(buf) >= self.shuffle_buffer:
                idx = self.rng.integers(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield process(buf.pop())
        while buf:
            idx = self.rng.integers(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield process(buf.pop())


class Batcher:
    """Collate processed samples into NHWC numpy batches.

    ``n_cond_views`` statically trims the 23-view cond tensor to the
    views actually used (max_views for train/eval, 24 for inference
    modes) — the static-shape equivalent of the reference's per-sample
    ragged slicing (model/view_fusion.py:249-251), and it cuts
    host->device transfer ~4x at max_views=6.

    ``pad_final=True`` (exact-epoch eval) emits the trailing partial
    batch too, padded to the static batch size by repeating its last
    sample, with an ``eval_mask`` key (1.0 = real sample, 0.0 = pad) so
    metrics can weight out the padding; full batches then carry an
    all-ones mask.  Default (False) drops the partial batch — the
    reference WebLoader's behavior.
    """

    def __init__(self, stream, batch_size: int,
                 n_cond_views: Optional[int] = None,
                 keys: Optional[List[str]] = None,
                 pad_final: bool = False):
        self.stream = stream
        self.batch_size = batch_size
        self.n_cond_views = n_cond_views
        self.keys = keys
        self.pad_final = pad_final

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batch: List[Dict[str, np.ndarray]] = []
        for sample in self.stream:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and self.pad_final:
            real = len(batch)
            batch = batch + [batch[-1]] * (self.batch_size - real)
            out = self._collate(batch)
            out["eval_mask"][real:] = 0.0
            yield out

    def _collate(self, batch) -> Dict[str, np.ndarray]:
        keys = self.keys or [k for k in batch[0] if k != "scene_hash"]
        out = {}
        for k in keys:
            items = [s[k] for s in batch]
            if k in ("cond", "relative_cond") and self.n_cond_views:
                # Trim per-sample BEFORE stacking: stacking all 23 cond
                # views then slicing copies ~4x the bytes actually kept.
                items = [x[: self.n_cond_views] for x in items]
            out[k] = np.stack(items)
        out["scene_hash"] = [s["scene_hash"] for s in batch]
        if self.pad_final:
            out["eval_mask"] = np.ones(len(batch), np.float32)
        return out


def prefetch(iterator, depth: int = 2):
    """Background-thread prefetch so host decode overlaps device compute
    (replaces the reference's persistent DataLoader workers,
    experiment.py:180-187).  Worker exceptions propagate to the consumer
    — an infinite (resampled) train stream must never end silently, or
    the trainer's epoch loop would busy-spin forever on a masked error."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def create_nmr_stream(
    split: SplitConfig,
    *,
    shuffle_buffer: int = 1000,
    seed: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    resample: bool = True,
    relative: bool = False,
    native: Optional[bool] = None,
    native_threads: int = 4,
    data_format: Optional[str] = None,
    needed_keys: Optional[Sequence[str]] = None,
    n_cond_views: Optional[int] = None,
    out_dtype: type = np.float32,
    process_mode: Optional[str] = None,
) -> NMRStream:
    """Factory mirroring the reference ``create_webdataset``
    (data/nmr_dataset.py:64-98)."""
    urls = expand_shard_urls(
        split.path, split.mode, split.start_shard, split.end_shard
    )
    return NMRStream(
        urls,
        mode=split.mode,
        shuffle_buffer=shuffle_buffer,
        seed=seed,
        host_id=host_id,
        num_hosts=num_hosts,
        resample=resample,
        relative=relative,
        native=native,
        native_threads=native_threads,
        data_format=data_format or getattr(split, "format", "auto"),
        needed_keys=needed_keys,
        n_cond_views=n_cond_views,
        out_dtype=out_dtype,
        process_mode=process_mode,
    )
