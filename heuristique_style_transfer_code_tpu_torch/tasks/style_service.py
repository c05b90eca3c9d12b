"""Style transfer as a service: batched jobs from concurrent clients
(``tasks/style_service.py`` of the JAX package).

Clients submit single images; a dispatcher thread packs them into batches
(padding with the batch's first job, choosing the smallest batch size of
the ladder that fits) and launches one job program per batch; a fetcher
thread copies the results to the host and resolves the futures. Kernel
launches are asynchronous, so the dispatcher only enqueues the device work
and the fetcher's ``.cpu()`` is where the host waits: ``max_in_flight``
bounds the batches between the two, as in the JAX service.

Three modes:

- **job_fn** (a feed-forward net through ``fast_style.make_net_job_fn``):
  one program, or a ``{batch_size: program}`` ladder.
- **texture** (``gram_fn=``): each job's own Gram is the target and the
  canvas starts from noise, optimised by the masked Adam loop
  (``tasks/style_transfer``) on ``make_per_image_gram_loss``.
  Job j's noise comes from a ``torch.Generator`` seeded from (seed, j), so
  it is deterministic per job and independent of its batch mates;
  ``jax.random.fold_in``'s numbers cannot be reproduced.
- **content+style** (``extract_fn=`` and ``styles=``): the gallery of named
  style images is encoded once, at construction, into one (K, ...) f32
  Gram stack a style layer on the device; each job's target is its row of
  blend weights contracted with the stacks (a one-hot row gives the
  gallery Gram bit for bit), and its canvas, started from the content
  image (``init="content"``) or from the job's noise, is optimised by
  the same loop on ``make_per_image_content_style_loss``.

``transport="yuv420"`` (JAX ``:198-211``, ``:345-386``) halves the pixel
bytes both ways: a job arrives as planar I420 (crop * 3/2, crop), packed
on the host by cv2 at submit, is unpacked on the device
(``camera.yuv420_to_rgb_device``, rounded back to uint8) before the mode's
job, and the stylised uint8 canvas is packed to I420 on the device
(``camera.rgb_to_yuv420_device``) before the fetch; the fetcher turns it
back into RGB with cv2, so clients send and receive RGB whatever the
transport. 4:2:0 chroma is lossy; the transport is opt-in.
"""
from __future__ import annotations

import functools
import queue
import threading
import time
from collections import deque
from collections.abc import Mapping
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.augment import eval_preprocess
from ..ops.resize import IMAGENET_MEAN, IMAGENET_STD
from .camera import (
    downscale_frame,
    rgb_to_yuv420,
    rgb_to_yuv420_device,
    yuv420_to_rgb_device,
)
from .style_transfer import (
    drive_masked_adam,
    make_per_image_content_style_loss,
    make_per_image_gram_loss,
    masked_adam_step,
)


@dataclass
class StyleJobResult:
    """One stylised job: ``image`` is the denormalised uint8 canvas,
    ``loss`` the job's final Gram-MSE (0 for a net), ``iterations`` the
    batch's iteration count (1 for a net)."""

    image: np.ndarray  # (crop, crop, 3) uint8
    loss: float
    iterations: int


def style_weights(style, names: List[str]) -> np.ndarray:
    """(K,) f32 blend weights from a gallery name, a {name: weight} mapping
    (normalised to sum 1), or None (the first style)."""
    if style is None:
        style = names[0]
    if isinstance(style, str):
        if style not in names:
            raise ValueError(f"unknown style {style!r}; gallery: {names}")
        w = np.zeros((len(names),), np.float32)
        w[names.index(style)] = 1.0
        return w
    unknown = [n for n in style if n not in names]
    if unknown:
        raise ValueError(f"unknown styles {unknown}; gallery: {names}")
    w = np.zeros((len(names),), np.float32)
    for n, v in style.items():
        v = float(v)
        if not np.isfinite(v) or v < 0:
            raise ValueError(f"style weight for {n!r} must be >= 0, got {v}")
        w[names.index(n)] = v
    total = float(w.sum())
    if total <= 0:
        raise ValueError("style weights must sum to > 0")
    return w / total


def _to_canvas(image: np.ndarray, crop: int) -> np.ndarray:
    """Validate an RGB uint8 image and downscale it to the (crop, crop)
    canvas with the canonical 256:224 staged geometry."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or 0 in image.shape[:2]:
        raise ValueError(f"image must be (H, W, 3) RGB with H, W > 0, got shape {image.shape}")
    if image.dtype != np.uint8:
        raise ValueError(f"image must be uint8, got dtype {image.dtype}")
    if image.shape[:2] != (crop, crop):
        shorter = max(crop, round(crop * 256 / 224))
        image = downscale_frame(image, crop=crop, shorter=shorter)
    return image


def job_noise(seed: int, job_id: int, shape) -> torch.Tensor:
    """Job ``job_id``'s f32 normal noise of ``shape``, on the CPU: a
    generator seeded from (seed, job_id) alone."""
    state = np.random.SeedSequence([int(seed), int(job_id)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state) & 0x7FFFFFFFFFFFFFFF)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def job_noises(seed: int, job_ids, shape, device) -> torch.Tensor:
    """``job_noise`` of each job id, stacked, on ``device``."""
    return torch.stack([job_noise(seed, j, shape) for j in job_ids]).to(device)


class StyleLoop(NamedTuple):
    """An iterative mode's job as three programs and its loop's settings
    (``StyleTransferService.loop``): ``prepare(images_u8, style_w[,
    noise0]) -> (pixels0, *loop)`` (``noise0`` given where ``noise``),
    ``loss(pixels, *loop) -> (B,)``, ``finish(pixels) -> uint8``; Adam's
    learning rate, the stop threshold, the iteration cap and the noise
    seed."""
    prepare: Callable
    loss: Callable
    finish: Callable
    noise: bool
    learning_rate: float
    threshold: float
    num_iterations: int
    seed: int


def loop_job(prepare: Callable, step: Callable, finish: Callable, noise_seed: Optional[int],
             num_iterations: int, crop: int, device: torch.device) -> Callable:
    """The batch job ``(images_u8, style_w, job_ids) -> (u8, iters,
    per_loss)`` of an iterative mode, from its three programs (a live
    service's ``StyleLoop``, or a style artifact's exported ones): the
    inputs go to ``device``, ``prepare`` (given ``job_noises(noise_seed,
    job_ids)`` where ``noise_seed`` is not None) gives the starting pixels
    and the loop's tensors, ``drive_masked_adam`` runs ``step(pixels, mu,
    nu, active, bc1, bc2, *loop)``, and ``finish`` makes the uint8
    canvases."""

    def job(images_u8, style_w, job_ids):
        images_u8 = torch.as_tensor(images_u8).to(device)
        w = torch.as_tensor(style_w, dtype=torch.float32).to(device)
        noise = () if noise_seed is None else (
            job_noises(noise_seed, job_ids, (crop, crop, 3), device),)
        pixels0, *rest = prepare(images_u8, w, *noise)
        pixels, iters, per_loss = drive_masked_adam(
            lambda *state: step(*state, *rest), pixels0, num_iterations)
        return finish(pixels), iters, per_loss

    job.iterative = True  # a warm dispatch would run the whole iteration cap
    return job


class StyleTransferService:
    """Dynamic-batching style-transfer job server.

    Parameters
    ----------
    gram_fn : per-image target-Gram program (``make_gram_fn_gram_attention``)
        — texture mode. Exclusive with ``extract_fn`` and ``job_fn``.
    extract_fn : per-image ``(feats, [style Grams])`` program
        (``make_extract_fn_gram_attention``) — content+style mode; needs
        ``styles``, a non-empty ``{name: (H, W, 3) uint8}`` mapping, and
        takes ``style_weight``, ``content_weight``, ``tv_weight`` and
        ``init`` ("content" or "noise").
    job_fn : a ``(images_u8, style_w, job_ids) -> (u8, iters, per_loss)``
        batch program, or a ``{batch_size: program}`` ladder (which then
        sets the batch sizes).
    batch_size : jobs per dispatch, or a sequence of sizes: each dispatch
        takes the smallest that fits the collected jobs.
    device : where the iterative modes' jobs run and where job inputs are
        copied (``cuda`` unless the caller asks for ``cpu``).
    The other parameters keep the JAX service's meaning.
    """

    def __init__(
        self,
        gram_fn: Optional[Callable] = None,
        *,
        extract_fn: Optional[Callable] = None,
        job_fn=None,
        style_names: Optional[List[str]] = None,
        styles: Optional[dict] = None,
        style_weight: float = 1.0,
        content_weight: float = 1.0,
        tv_weight: float = 0.0,
        init: str = "content",
        crop: int = 224,
        batch_size=8,
        max_delay_ms: float = 200.0,
        num_iterations: int = 500,
        threshold: float = 1e-4,
        learning_rate: float = 0.01,
        max_in_flight: int = 2,
        max_queue: int = 256,
        seed: int = 0,
        transport: str = "rgb",
        device="cuda",
    ):
        if transport not in ("rgb", "yuv420"):
            raise ValueError(f"transport must be 'rgb' or 'yuv420', got {transport!r}")
        if transport == "yuv420" and int(crop) % 4:
            raise ValueError("yuv420 transport needs crop % 4 == 0")
        self.transport = transport
        if sum(f is not None for f in (gram_fn, extract_fn, job_fn)) != 1:
            raise ValueError("pass exactly one of gram_fn (texture mode), extract_fn "
                             "(content+style mode) or job_fn (a pre-built/AOT program)")
        if extract_fn is not None and not styles:
            raise ValueError("content+style mode requires a non-empty styles=")
        if extract_fn is None and styles:
            raise ValueError("styles= only applies to content+style mode")
        if style_names is not None and job_fn is None:
            raise ValueError("style_names= only applies with job_fn=")
        if init not in ("content", "noise"):
            raise ValueError(f"init must be 'content' or 'noise', got {init!r}")
        self.device = resolve_device(device)
        self.crop = int(crop)

        if isinstance(job_fn, Mapping):
            jobs_by_size = {int(s): f for s, f in job_fn.items()}
            sizes = sorted(jobs_by_size)
        else:
            try:
                sizes = sorted({int(b) for b in batch_size})
            except TypeError:
                sizes = [int(batch_size)]
            if job_fn is not None and len(sizes) > 1:
                raise ValueError("a bare job_fn= callable serves ONE batch size; for "
                                 "multi-size dispatch pass a mapping {batch_size: job_fn}")
            jobs_by_size = None
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1, got {batch_size}")
        self.batch_sizes = sizes
        self.batch_size = sizes[-1]
        self.max_delay = max_delay_ms / 1e3
        self.num_iterations = int(num_iterations)
        self.style_names = list(styles or style_names or [])  # the two are exclusive

        mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        std = torch.as_tensor(IMAGENET_STD, device=self.device)

        def finish(pixels):
            canvas = torch.clamp(pixels * std + mean, 0.0, 1.0)
            return torch.round(canvas * 255.0).to(torch.uint8)

        # An iterative mode is three programs and the loop between them:
        # ``prepare(images_u8, style_w[, noise0]) -> (pixels0, *loop)`` on
        # the device, ``drive_masked_adam`` over ``masked_adam_step`` on
        # ``loss(pixels, *loop) -> (B,)`` (``loop_job``), and
        # ``finish(pixels) -> uint8``.
        # The live job runs them here; ``deploy/artifact.py`` exports the
        # same three (``self.loop``), and ``loop_job`` runs them as here.
        self.loop = None
        if gram_fn is not None:
            def prepare(images_u8, style_w, noise0):
                del style_w  # texture mode: the target is the job's own Gram
                with torch.no_grad():
                    targets = gram_fn(eval_preprocess(images_u8, self.crop))
                return (noise0, *targets)

            self.loop = StyleLoop(prepare, make_per_image_gram_loss(gram_fn), finish, True, float(learning_rate),
                                  float(threshold), int(num_iterations), int(seed))
        elif extract_fn is not None:
            style_u8 = np.stack([_to_canvas(im, self.crop) for im in styles.values()])
            with torch.no_grad():  # per style layer, the (K, ...) gallery stack
                gram_stacks = [g.float() for g in extract_fn(eval_preprocess(
                    torch.as_tensor(style_u8).to(self.device), self.crop))[1]]
            per_image_loss = make_per_image_content_style_loss(extract_fn, style_weight,
                                                               content_weight, tv_weight)

            def prepare(images_u8, style_w, *noise0):
                images = eval_preprocess(images_u8, self.crop)
                with torch.no_grad():
                    content_feats = extract_fn(images)[0].float()
                # each job's convex Gram blend; a one-hot row is exact in f32
                grams = [torch.einsum("bk,k...->b...", style_w, gs) for gs in gram_stacks]
                pixels0 = images.float() if init == "content" else noise0[0]
                return (pixels0, *grams, content_feats)

            def loss(pixels, *grams_and_feats):
                return per_image_loss(pixels, grams_and_feats[:-1], grams_and_feats[-1])

            self.loop = StyleLoop(prepare, loss, finish, init == "noise",
                                  float(learning_rate), float(threshold), int(num_iterations),
                                  int(seed))
        if self.loop is not None:
            loop = self.loop
            job = loop_job(loop.prepare, functools.partial(masked_adam_step, loop.loss,
                                                           loop.learning_rate, loop.threshold),
                           loop.finish, loop.seed if loop.noise else None, loop.num_iterations,
                           self.crop, self.device)
            self._jobs_by_size = {s: job for s in sizes}
        elif jobs_by_size is not None:
            self._jobs_by_size = jobs_by_size
        else:
            self._jobs_by_size = {s: job_fn for s in sizes}
        # the RGB jobs, whatever the transport: what deploy/artifact.py
        # exports (an artifact is served with either transport)
        self._raw_jobs_by_size = dict(self._jobs_by_size)
        if transport == "yuv420":
            c = self.crop

            def with_yuv_transport(inner):
                def yuv_job(yuv_u8, style_w, job_ids):
                    yuv = torch.as_tensor(yuv_u8).to(self.device)
                    rgb_u8 = torch.round(yuv420_to_rgb_device(yuv, c, c) * 255.0).to(torch.uint8)
                    out_u8, iters, per_loss = inner(rgb_u8, style_w, job_ids)
                    return rgb_to_yuv420_device(out_u8), iters, per_loss

                return yuv_job

            self._jobs_by_size = {s: with_yuv_transport(f) for s, f in self._jobs_by_size.items()}

        self._next_id = 0
        self._id_lock = threading.Lock()
        self.max_queue = int(max_queue)
        self._requests: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._in_flight: "queue.Queue" = queue.Queue(maxsize=int(max_in_flight))
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._batches = 0
        self._jobs = 0
        self._iters_sum = 0
        self._occupancy_sum = 0.0
        self._size_hist: dict = {}
        self._consecutive_failures = 0
        self._latencies = deque(maxlen=2048)
        self._started = None
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._fetcher = threading.Thread(target=self._fetch_loop, daemon=True)

    # ---- client API ----------------------------------------------------

    def start(self) -> "StyleTransferService":
        self._started = time.perf_counter()
        self._dispatcher.start()
        self._fetcher.start()
        return self

    def warmup(self) -> None:
        """Build the kernels; in job_fn mode also run one forward per ladder
        size on zeros (cuDNN's algorithm choice, the allocator). The
        iterative modes only build: a warm dispatch would run the whole
        iteration cap."""
        if self.device.type == "cuda":
            from ..ops.kernels import build_all

            build_all()
        if any(getattr(f, "iterative", False) for f in self._raw_jobs_by_size.values()):
            return
        width = max(1, len(self.style_names))
        c = self.crop
        tail = (c * 3 // 2, c) if self.transport == "yuv420" else (c, c, 3)
        for b in self.batch_sizes:
            w = np.zeros((b, width), np.float32)
            w[:, 0] = 1.0
            out = self._jobs_by_size[b](np.zeros((b,) + tail, np.uint8), w,
                                        np.zeros((b,), np.int32))
            out[0].cpu()

    def submit(self, image: np.ndarray, style=None) -> Future:
        """Submit one RGB uint8 image; returns a Future resolving to a
        StyleJobResult. Images larger than (crop, crop) are downscaled in
        the caller's thread (and packed to I420 there under the yuv420
        transport). ``style`` picks a gallery style by name or blends
        several with a ``{name: weight}`` mapping; texture mode takes no
        style."""
        if self._stop.is_set():
            raise RuntimeError("service is stopped")
        if self.style_names:
            style_w = style_weights(style, self.style_names)
        elif style is not None:
            raise ValueError("texture mode takes no style= (no gallery)")
        else:
            style_w = np.zeros((1,), np.float32)
        image = _to_canvas(image, self.crop)
        if self.transport == "yuv420":
            image = rgb_to_yuv420(image)  # (crop*3//2, crop), host cv2
        with self._id_lock:
            job_id = self._next_id
            self._next_id += 1
        fut: Future = Future()
        t = time.perf_counter()
        fut._hst_submit_time = t
        self._requests.put((image, style_w, job_id, fut, t))
        if self._stop.is_set() and fut.cancel():
            raise RuntimeError("service is stopped")
        return fut

    def _cancel_queued(self) -> None:
        try:
            while True:
                item = self._requests.get_nowait()
                if item is not None:
                    item[3].cancel()
        except queue.Empty:
            pass

    def stop(self, drain: bool = True) -> None:
        """Stop the workers; with ``drain`` every job submitted so far is
        answered first, otherwise queued jobs are cancelled."""
        if self._started is None:
            self._stop.set()
            self._cancel_queued()
            return
        if not drain:
            self._stop.set()
        self._requests.put(None)
        self._dispatcher.join()
        self._in_flight.put(None)
        self._fetcher.join()
        self._stop.set()
        self._cancel_queued()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)

    def health(self, max_consecutive_failures: int = 3) -> tuple:
        if self._started is None or self._stop.is_set():
            return False, "service not running"
        if not (self._dispatcher.is_alive() and self._fetcher.is_alive()):
            return False, "worker thread dead"
        with self._stats_lock:
            n = self._consecutive_failures
        if n >= max_consecutive_failures:
            return False, f"device path failing ({n} consecutive batch errors)"
        return True, "ok"

    def healthy(self, max_consecutive_failures: int = 3) -> bool:
        return self.health(max_consecutive_failures)[0]

    def stats(self) -> dict:
        with self._stats_lock:
            elapsed = time.perf_counter() - self._started if self._started else 0.0
            lats = sorted(self._latencies)

            def pct(p):
                if not lats:
                    return 0.0
                return lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3

            return {
                "batches": self._batches,
                "jobs": self._jobs,
                "transport": self.transport,
                "mean_batch_occupancy": (
                    self._occupancy_sum / self._batches if self._batches else 0.0),
                "mean_iterations": self._iters_sum / self._batches if self._batches else 0.0,
                "jobs_per_sec": self._jobs / elapsed if elapsed > 0 else 0.0,
                "latency_p50_ms": pct(0.50),
                "latency_p95_ms": pct(0.95),
                "batch_size_hist": {str(k): v for k, v in sorted(self._size_hist.items())},
            }

    # ---- internals -----------------------------------------------------

    def _collect_batch(self) -> Optional[tuple]:
        item = self._requests.get()
        if item is None:
            return None
        images, sidx, ids, futures = [item[0]], [item[1]], [item[2]], [item[3]]
        deadline = item[4] + self.max_delay
        while len(images) < self.batch_size:
            timeout = deadline - time.perf_counter()
            try:
                if timeout <= 0:
                    item = self._requests.get_nowait()
                else:
                    item = self._requests.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._requests.put(None)
                break
            images.append(item[0])
            sidx.append(item[1])
            ids.append(item[2])
            futures.append(item[3])
        return images, sidx, ids, futures

    @staticmethod
    def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None) -> None:
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:  # cancelled: the client gave up
            pass

    def _fail(self, futures: List[Future], exc: BaseException) -> None:
        for f in futures:
            self._resolve(f, exc=exc)
        with self._stats_lock:
            self._consecutive_failures += 1

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect_batch()
            if batch is None:
                break
            images, sidx, ids, futures = batch
            n = len(images)
            size = next(s for s in self.batch_sizes if s >= n)
            if n < size:  # pad with the first job
                images = images + [images[0]] * (size - n)
                sidx = sidx + [sidx[0]] * (size - n)
                ids = ids + [ids[0]] * (size - n)
            try:
                out = self._jobs_by_size[size](
                    np.stack(images), np.stack(sidx).astype(np.float32),
                    np.asarray(ids, np.int32))
            except Exception as e:  # a CUDA error answers this batch, the server goes on
                self._fail(futures, e)
                continue
            self._in_flight.put((out, futures, n, size))

    def _fetch_loop(self) -> None:
        while True:
            item = self._in_flight.get()
            if item is None:
                break
            (pixels, iters, per_loss), futures, n, size = item
            try:
                pixels = pixels.cpu().numpy()  # waits for the batch's kernels
                iters = int(iters)
                per_loss = torch.as_tensor(per_loss).cpu().numpy()
                if self.transport == "yuv420":
                    # back to RGB on the host, inside this try: a decode
                    # failure answers the batch instead of killing the thread
                    import cv2

                    pixels = np.stack([cv2.cvtColor(p, cv2.COLOR_YUV2RGB_I420) for p in pixels])
            except Exception as e:
                self._fail(futures, e)
                continue
            now = time.perf_counter()
            lats = []
            for i, f in enumerate(futures):
                self._resolve(f, StyleJobResult(image=pixels[i], loss=float(per_loss[i]),
                                                iterations=iters))
                lats.append(now - f._hst_submit_time)
            with self._stats_lock:
                self._batches += 1
                self._jobs += n
                self._iters_sum += iters
                self._consecutive_failures = 0
                self._occupancy_sum += n / size
                self._size_hist[size] = self._size_hist.get(size, 0) + 1
                self._latencies.extend(lats)
