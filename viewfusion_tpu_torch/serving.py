"""Inference serving on PyTorch: the dynamic-batching novel-view server
(counterpart of ``viewfusion_tpu/serving.py``, same API and HTTP surface).

  * requests carry N conditioning views (PNG or JPEG bytes, or [0,1]
    arrays) and a target azimuth; responses carry the generated view;
  * a background worker coalesces queued requests into fixed-size batches,
    one batch per (steps, sampler) bucket, served oldest-waiting-request
    first so a minority bucket is never starved by majority traffic;
  * "ddim" (default, eta=1), "dpm" and "dpm_sde" samplers; abandoned
    requests are skipped, client input errors map to 400s, body size and
    step counts are bounded;
  * each request's decode, queue wait and encode, and each batch's
    assembly, copies and sampler steps, are spans of ``tracing.py``
    (keyed by request and batch id); refused, timed-out and abandoned
    requests are counted there.

Usage:
    python -m viewfusion_tpu_torch.serving -s <run-dir> --port 8000
    POST /generate  {"views": [<b64 image>...], "angle": 1.57,
                     "steps": 50, "sampler": "ddim"}
    GET  /healthz

A run dir is the JAX package's: ``config.yaml`` and the checkpoint
``best_model_all.msgpack``, else ``model.msgpack`` (read by
``training/checkpoint.py``), so the service serves run dirs of either
package.  Views are decoded by ``utils/image.py:decode_image`` (PNG,
JPEG, WebP, GIF, BMP and TIFF, equal to the JAX server's PIL; a form it
does not read is a 400 naming it, and so is a view larger than the
model's, before its data is decoded), replies encoded by the port's PNG
codec.  The service runs on CUDA unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import Config, load_config
from viewfusion_tpu_torch.models.unet import cast_matmul_weights_
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.training.checkpoint import Checkpoint
from viewfusion_tpu_torch.utils.convert import (unet_params_to_jax,
                                                unet_state_dict_from_jax)
from viewfusion_tpu_torch.utils.device import to_device
from viewfusion_tpu_torch.utils.image import decode_image
from viewfusion_tpu_torch.utils.png import FrameTooLarge, encode_png

__all__ = ["ViewFusionService", "ClientError", "make_server", "serve",
           "main", "write_run_dir"]

MAX_BODY_BYTES = 64 * 1024 * 1024  # generous: 24 views of raw float lists
_SAMPLERS = ("ddim", "dpm", "dpm_sde")


class ClientError(ValueError):
    """Invalid client input -> HTTP 400."""


@dataclass
class _Request:
    cond: np.ndarray          # (N, H, W, 3) float32 [0,1]
    angle: float
    steps: int
    sampler: str
    deadline: float
    arrival: float = field(default_factory=time.monotonic)
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    queued: Any = None        # its open serve.queue span
    popped_ns: int = 0        # when the worker took it into a batch

    @property
    def abandoned(self) -> bool:
        return time.monotonic() > self.deadline


def write_run_dir(run_dir: str, config: Config,
                  params: Dict[str, torch.Tensor],
                  ema_params: Optional[Dict[str, torch.Tensor]] = None
                  ) -> None:
    """Write a run dir of the JAX layout that :class:`ViewFusionService`
    (and the JAX package's ``-e``/``-i`` and service) reads:
    ``config.yaml`` and a ``best_model_all.msgpack`` holding ``params``
    (and ``ema_params``) of the port's UNet ``state_dict``s."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        f.write(config.to_yaml())
    state = {"params": unet_params_to_jax(params)}
    if ema_params is not None:
        state["ema_params"] = unet_params_to_jax(ema_params)
    Checkpoint(run_dir).save("best_model_all.msgpack", state)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to serve on the CPU")
    return device


class ViewFusionService:
    """Serves batched generation from a run dir (``config.yaml`` and
    ``best_model_all.msgpack``, else ``model.msgpack``);
    :meth:`from_state_dict` builds one from a ``Config`` and weights in
    memory.

    ``max_views`` bounds the conditioning buffer (default: the config's
    max_views).  Weights move to ``device`` once, conv/linear weights in
    the compute dtype; batches reach it by ``to_device``'s pinned copy."""

    def __init__(self, run_dir: str, batch_size: int = 8,
                 max_wait_ms: float = 30.0, default_steps: int = 50,
                 request_timeout: float = 900.0,
                 max_views: Optional[int] = None, device="cuda"):
        config = load_config(os.path.join(run_dir, "config.yaml"))
        ckpt = Checkpoint(run_dir)
        name = ("best_model_all.msgpack"
                if ckpt.exists("best_model_all.msgpack") else "model.msgpack")
        # EMA-trained runs serve the EMA shadow (the weights eval scored);
        # a checkpoint without one serves its raw params, never random ones
        use_ema = config.train.ema_decay > 0
        template = dict.fromkeys(
            ("params", "ema_params") if use_ema else ("params",))
        restored, _ = ckpt.load(name, template)
        if use_ema and "ema_params" in ckpt.last_missing:
            print(f"WARNING: {name} has no ema_params field despite "
                  "tpu.ema_decay > 0; serving the checkpoint's raw params "
                  "instead.", flush=True)
            use_ema = False
        weights = unet_state_dict_from_jax(
            restored["ema_params" if use_ema else "params"])
        self._setup(config, weights, batch_size, max_wait_ms, default_steps,
                    request_timeout, max_views, device)

    @classmethod
    def from_state_dict(cls, config: Config,
                        state_dict: Dict[str, torch.Tensor],
                        batch_size: int = 8, max_wait_ms: float = 30.0,
                        default_steps: int = 50,
                        request_timeout: float = 900.0,
                        max_views: Optional[int] = None,
                        device="cuda") -> "ViewFusionService":
        self = cls.__new__(cls)
        self._setup(config, state_dict, batch_size, max_wait_ms,
                    default_steps, request_timeout, max_views, device)
        return self

    def _setup(self, config, state_dict, batch_size, max_wait_ms,
               default_steps, request_timeout, max_views, device):
        self.device = _resolve_device(device)
        self.config = config
        with tracing.span("setup.model"):
            self.model = ViewFusion.from_config(config)
            self.model.unet.load_state_dict(state_dict)
            self.model.unet.to(self.device).eval()
            cast_matmul_weights_(self.model.unet, self.model.unet.dtype)
        self.n_max = max_views or config.data.max_views
        self.image_size = config.denoiser.image_size
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.default_steps = default_steps
        self.request_timeout = request_timeout
        self.max_steps = self.model.schedule.num_timesteps
        # one FIFO per (steps, sampler) bucket; the worker serves the
        # bucket whose HEAD request has waited longest (see _run)
        self._cond = threading.Condition()
        self._buckets: "dict[tuple, deque[_Request]]" = {}
        self._counter = 0                       # batch ids
        self._request_ids = itertools.count(1)  # the HTTP requests' ids
        # (steps, sampler, requests, seconds) of the latest device batches
        self.batch_log: "deque[tuple]" = deque(maxlen=1024)
        self.warmed_steps: List[tuple] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def _sample(self, sampler: str, cond, counts, angles, steps: int,
                generator):
        self._check_sampler(sampler)
        with torch.inference_mode():
            if sampler == "ddim":
                return self.model.generate_ddim(cond, counts, angles,
                                                num_steps=steps,
                                                generator=generator)
            return self.model.generate_dpm(cond, counts, angles,
                                           num_steps=steps,
                                           generator=generator,
                                           sde=sampler == "dpm_sde")

    @staticmethod
    def _check_sampler(sampler: str) -> None:
        if sampler not in _SAMPLERS:
            raise ClientError(
                f'sampler must be "ddim", "dpm", or "dpm_sde", '
                f'got {sampler!r}')

    def warmup(self, steps_list: Optional[List[int]] = None,
               sampler: str = "ddim") -> None:
        """Run the sampler once per step-count bucket before traffic, so
        the kernel build and cuDNN's first-call setup are paid here and
        not by a request.  ``sampler`` picks the bucket family."""
        b, hw = self.batch_size, self.image_size
        for steps in steps_list or [self.default_steps]:
            steps = int(steps)
            if not 1 <= steps <= self.max_steps:
                raise ValueError(
                    f"warmup steps must be in [1, {self.max_steps}], "
                    f"got {steps}")
            with tracing.span("setup.warmup", steps=steps):
                out = self._sample(
                    sampler,
                    torch.zeros((b, self.n_max, hw, hw, 3),
                                device=self.device),
                    torch.ones((b,), dtype=torch.int64, device=self.device),
                    torch.zeros((b,), device=self.device), steps,
                    torch.Generator(device=self.device).manual_seed(0))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            del out
            self.warmed_steps.append((steps, sampler))

    # ------------------------------------------------------------------
    def submit(self, cond: np.ndarray, angle: float,
               steps: Optional[int] = None,
               timeout: Optional[float] = None,
               sampler: str = "ddim") -> np.ndarray:
        """Blocking generate; thread-safe.  Raises ClientError on invalid
        input (HTTP layer maps it to 400).  The request's wait in the
        queue is a ``serve.queue`` span under the caller's open span."""
        cond = np.asarray(cond)
        if cond.ndim != 4 or cond.shape[-1] != 3:
            raise ClientError(f"cond must be (N, H, W, 3), got {cond.shape}")
        if cond.shape[0] < 1:
            raise ClientError("at least one conditioning view required")
        if cond.shape[0] > self.n_max:
            raise ClientError(
                f"at most {self.n_max} conditioning views supported")
        if cond.shape[1] != self.image_size or \
                cond.shape[2] != self.image_size:
            raise ClientError(
                f"views must be {self.image_size}x{self.image_size}")
        steps = self.default_steps if steps is None else int(steps)
        if not 1 <= steps <= self.max_steps:
            raise ClientError(
                f"steps must be in [1, {self.max_steps}], got {steps}")
        self._check_sampler(sampler)
        if sampler in ("dpm", "dpm_sde") and steps < 2:
            raise ClientError("dpm requires steps >= 2")
        try:
            angle = float(angle)
        except (TypeError, ValueError):
            raise ClientError(f"angle must be a number, got {angle!r}")

        wait = self.request_timeout if timeout is None else timeout
        req = _Request(cond=cond.astype(np.float32), angle=angle,
                       steps=steps, sampler=sampler,
                       deadline=time.monotonic() + wait)
        req.queued = tracing.begin("serve.queue", stack=False)
        with self._cond:
            self._buckets.setdefault((steps, sampler), deque()).append(req)
            self._cond.notify()
        if not req.event.wait(wait):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    # ------------------------------------------------------------------
    def _run(self) -> None:
        # Pick the bucket whose HEAD request has waited longest, wait up
        # to max_wait_ms for it to fill, run one device batch, repeat:
        # service order is FIFO across buckets at batch granularity.
        while True:
            with self._cond:
                key = None
                while key is None:
                    for k in list(self._buckets):
                        dq = self._buckets[k]
                        while dq and dq[0].abandoned:
                            self._abandon(dq.popleft())
                        if not dq:
                            del self._buckets[k]
                    if self._buckets:
                        key = min(self._buckets,
                                  key=lambda k: self._buckets[k][0].arrival)
                    else:
                        self._cond.wait()
                dq = self._buckets[key]
                deadline = time.perf_counter() + self.max_wait_ms / 1e3
                while len(dq) < self.batch_size:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = [dq.popleft()
                         for _ in range(min(self.batch_size, len(dq)))]
                if not dq:
                    del self._buckets[key]
            popped = time.perf_counter_ns()
            for r in batch:
                r.popped_ns = popped
            self._generate(batch, *key)

    @staticmethod
    def _abandon(req: _Request) -> None:
        tracing.count("serve.abandoned")
        tracing.end(req.queued)

    def _generate(self, reqs: List[_Request], steps: int,
                  sampler: str = "ddim") -> None:
        live = []
        for r in reqs:
            if r.abandoned:
                self._abandon(r)
            else:
                live.append(r)
        reqs = live
        if not reqs:
            return
        self._counter += 1
        bid = self._counter  # the batch's id, and its generator's seed
        for r in reqs:
            tracing.end(r.queued, r.popped_ns, batch=bid)
        b, hw = self.batch_size, self.image_size
        with tracing.span("serve.assemble", key=bid):
            cond = np.zeros((b, self.n_max, hw, hw, 3), np.float32)
            counts = np.ones((b,), np.int64)
            angles = np.zeros((b,), np.float32)
            for i in range(b):
                r = reqs[min(i, len(reqs) - 1)]  # pad with the last request
                counts[i] = r.cond.shape[0]
                cond[i, : counts[i]] = r.cond
                angles[i] = r.angle
        # serve.batch and batch_log share their two clock readings
        t0, t1 = time.perf_counter_ns(), None
        span = tracing.begin(
            "serve.batch", key=bid, start=t0,
            request_ids=tuple(r.queued.key for r in reqs
                              if r.queued is not None
                              and r.queued.key is not None),
            requests=len(reqs), views=int(counts[:len(reqs)].sum()),
            rows=b * self.n_max)
        try:
            gen = torch.Generator(device=self.device).manual_seed(
                0x5E11 + bid)
            with tracing.span("serve.h2d"):
                args = to_device((cond, counts, angles), self.device)
            out = self._sample(sampler, *args, steps, gen)
            with tracing.span("serve.copy_back"):
                out = out.cpu()
            images = np.clip(out.numpy(), 0.0, 1.0)
            t1 = time.perf_counter_ns()
            self.batch_log.append((steps, sampler, len(reqs),
                                   (t1 - t0) / 1e9))
            tracing.end(span, t1)
            for i, r in enumerate(reqs):
                r.result = images[i]
                r.event.set()
        except Exception as e:  # surface device errors to callers
            if t1 is None:
                tracing.end(span)
            for r in reqs:
                r.error = str(e)
                r.event.set()


def _decode_views(payload: dict,
                  image_size: Optional[int] = None) -> np.ndarray:
    """The views of a request as (N, H, W, 3) float32.  An image file
    whose header declares more than ``image_size`` rows or columns (the
    service's views, which the JAX server refuses after its decode) is
    refused before its data is decoded."""
    views = payload.get("views")
    if not isinstance(views, list) or not views:
        raise ClientError('"views" must be a non-empty list')
    decoded = []
    for item in views:
        if isinstance(item, str):  # a base64 image file
            try:
                img = decode_image(base64.b64decode(item), image_size)
            except FrameTooLarge as e:
                raise ClientError(
                    f"views must be {image_size}x{image_size}: {e}")
            except ValueError as e:  # binascii.Error is one
                raise ClientError(f"undecodable view image: {e}")
            decoded.append(img.astype(np.float32) / 255.0)
        else:  # nested lists
            try:
                arr = np.asarray(item, np.float32)
            except (TypeError, ValueError) as e:
                raise ClientError(f"invalid view array: {e}")
            if arr.ndim != 3:
                raise ClientError(
                    f"invalid view array: expected (H, W, 3), "
                    f"got shape {arr.shape}")
            decoded.append(arr)
    try:
        return np.stack(decoded)
    except ValueError as e:
        raise ClientError(f"views have inconsistent shapes: {e}")


def make_server(service: ViewFusionService, host: str = "0.0.0.0",
                port: int = 0) -> ThreadingHTTPServer:
    """Build the HTTP server (port 0 = ephemeral, for tests)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "image_size": service.image_size,
                                 "max_views": service.n_max,
                                 "max_steps": service.max_steps})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            with tracing.span("serve.request",
                              key=next(service._request_ids)):
                self._post_generate()

        def _post_generate(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._send(413, {"error": "request body too large"})
                    return
                body = self.rfile.read(length)
                with tracing.span("serve.decode"):
                    payload = json.loads(body)
                    if not isinstance(payload, dict):
                        raise ClientError("body must be a JSON object")
                    if "angle" not in payload:
                        raise ClientError('"angle" is required')
                    cond = _decode_views(payload, service.image_size)
                img = service.submit(
                    cond, payload["angle"], payload.get("steps"),
                    sampler=payload.get("sampler", "ddim"))
                with tracing.span("serve.encode"):
                    png = base64.b64encode(
                        encode_png((img * 255).astype(np.uint8))).decode()
                self._send(200, {"image": png})
            except (ClientError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                tracing.count("serve.refused")
                self._send(400, {"error": str(e)})
            except TimeoutError as e:
                tracing.count("serve.timed_out")
                self._send(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def serve(run_dir: str, host: str = "0.0.0.0", port: int = 8000,
          batch_size: int = 8, default_steps: int = 50,
          max_views: Optional[int] = None, warmup: bool = True,
          warmup_steps: Optional[List[int]] = None,
          warmup_samplers: Optional[List[str]] = None,
          device="cuda") -> None:
    service = ViewFusionService(run_dir, batch_size=batch_size,
                                default_steps=default_steps,
                                max_views=max_views, device=device)
    if warmup:
        # the default bucket is always warmed; warmup_steps adds buckets
        buckets = list(warmup_steps or [])
        if default_steps not in buckets:
            buckets.insert(0, default_steps)
        samplers = warmup_samplers or ["ddim"]
        print(f"warming up step buckets {buckets} x {samplers}...",
              flush=True)
        for s in samplers:
            service.warmup(buckets, sampler=s)
    httpd = make_server(service, host, port)
    print(f"serving {run_dir} on {host}:{httpd.server_address[1]}")
    httpd.serve_forever()


def _enable_hang_diagnostics() -> None:
    """SIGUSR1 dumps every thread's Python stack to stderr
    (``kill -USR1 <pid>``) without stopping the server."""
    import faulthandler
    import signal

    try:
        # chain=False: chaining to SIG_DFL would terminate after the dump
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    except (AttributeError, ValueError, io.UnsupportedOperation):
        pass  # non-main thread, no SIGUSR1, or no real stderr


def main(argv=None) -> None:
    _enable_hang_diagnostics()
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--src", required=True, help="run directory")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--max-views", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup run of the default sampler")
    p.add_argument("--warmup-steps", default=None,
                   help="comma-separated step buckets to run at startup "
                        "(e.g. 50,250); default: the --steps bucket only")
    p.add_argument("--warmup-samplers", default="ddim",
                   help="comma-separated sampler families to warm up "
                        "(ddim,dpm,dpm_sde)")
    args = p.parse_args(argv)
    buckets = None
    if args.warmup_steps:
        buckets = [int(s) for s in args.warmup_steps.split(",") if s]
        if args.steps not in buckets:
            buckets.insert(0, args.steps)
    samplers = [s for s in args.warmup_samplers.split(",") if s]
    serve(args.src, args.host, args.port, args.batch_size, args.steps,
          args.max_views, warmup=not args.no_warmup, warmup_steps=buckets,
          warmup_samplers=samplers, device=args.device)


if __name__ == "__main__":
    main()
