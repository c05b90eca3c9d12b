"""Multi-stream batched inference serving (``tasks/serving.py`` of the JAX
package).

Many concurrent clients (cameras, HTTP handlers) submit frames and get a
Future back; a dispatcher thread packs the requests into batches of one
static shape for the model's forward, and a fetcher thread resolves the
futures in FIFO order.

- **One static batch shape.** A deadline flush pads the tail with the
  batch's own first frame (never zeros) and resolves only the real
  requests' futures.
- **Deadline-based dynamic batching.** A batch goes out when it is full or
  when its oldest request has waited ``max_delay_ms``; an expired deadline
  still takes everything already queued, so a backlog drains as full
  batches.
- **Pipelined dispatch.** Up to ``max_in_flight`` batches wait between the
  dispatcher and the fetcher before the dispatcher blocks.

On the card the two threads never share a stream's order by accident. The
dispatcher stacks each batch into a pinned host buffer, copies it onto the
model's device without blocking on a stream of its own, launches the
forward under ``torch.inference_mode()`` (thread-local, so entered in the
dispatcher thread itself), queues the copy of the probabilities into
pinned host memory and records a CUDA event. The fetcher waits on that
event before it reads the probabilities, and only then gives the batch's
input buffer back: one pinned buffer per batch that can be alive at once
(``max_in_flight`` queued, one being built, one being fetched), so no
buffer is refilled while its copy may still be pending. A CUDA error may
surface only at the event: either loop fails that batch's futures and
counts a failure; neither goes on to the CPU.

``mesh=`` (a ``core.mesh.DeviceGroup``, ``--devices N``): one replica a
device, each with its model (a copy on its device), its pinned staging
buffers and its stream. A padded batch of B rows goes out as N blocks of
B / N rows, replica k running block k, and the N results are copied into
one pinned output, one event a replica; the fetcher waits on all N. On
the CPU the replicas run one after the other in the dispatcher.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.device import device_of, resolve_device
from ..core.mesh import row_blocks
from .camera import (
    downscale_frame,
    make_camera_infer_fn,
    make_camera_infer_fn_yuv,
    rgb_to_yuv420,
)


def prepare_frame(frame: np.ndarray, crop: int) -> np.ndarray:
    """Validate one RGB uint8 frame and host-downscale it to (crop, crop, 3)
    with the canonical 256:224 staged geometry, in the caller's thread.
    Shared by ``submit`` and the recycling proxy (``tasks/recycling.py``),
    so the parent's validation raises the errors the in-process service
    would."""
    frame = np.asarray(frame)
    # validated here: a malformed frame fails the one client that sent it,
    # never np.stack in the dispatcher, where it would fail its batch mates
    if frame.ndim != 3 or frame.shape[2] != 3 or 0 in frame.shape[:2]:
        raise ValueError(
            f"frame must be (H, W, 3) RGB with H, W > 0, got shape {frame.shape}"
        )
    if frame.dtype != np.uint8:
        raise ValueError(f"frame must be uint8, got dtype {frame.dtype}")
    if frame.shape[:2] != (crop, crop):
        # keep the canonical resize:crop ratio (256:224) for any crop
        shorter = max(crop, round(crop * 256 / 224))
        frame = downscale_frame(frame, crop=crop, shorter=shorter)
    return frame


class BatchingInferenceServer:
    """Dynamic-batching inference server over a batch forward.

    Parameters
    ----------
    forward_eval : ``fn(model, images (B, crop, crop, 3) float) -> logits``,
        the contract of the camera and evaluation paths.
    model : the model (an ``nn.Module`` on its device).
    batch_size : the static batch B.
    max_delay_ms : flush deadline of a partially filled batch.
    max_in_flight : batches queued for the fetcher before the dispatcher
        blocks.
    max_queue : bound of the request queue (``submit`` blocks when full).
    compute_dtype : e.g. ``torch.bfloat16``.
    transport : "rgb" ships (crop, crop, 3) uint8 frames; "yuv420" packs
        each frame to planar I420 in the submitting client's thread (cv2)
        and ships 1.5 bytes a pixel; the device converts it back to RGB
        before the forward.
    mesh : a ``core.mesh.DeviceGroup``: one replica a device (module
        docstring); B must be a multiple of its size.
    infer_fn : ``fn(model, batch_u8) -> probs`` used instead of building
        one from ``forward_eval`` (``model`` may then be None); it gets
        the batch on ``device`` in the format of ``transport``. With a
        ``mesh``, a sequence of them, one a replica (an artifact's
        programs, one a device).
    device : where batches go; default the model's device, or ``cuda``
        when there is no model (with a ``mesh``, its devices).
    """

    def __init__(
        self,
        forward_eval: Optional[Callable],
        model,
        *,
        batch_size: int = 64,
        max_delay_ms: float = 10.0,
        max_in_flight: int = 3,
        max_queue: int = 1024,
        compute_dtype: Optional[torch.dtype] = None,
        crop: int = 224,
        transport: str = "rgb",
        mesh=None,
        infer_fn: Optional[Callable] = None,
        device=None,
    ):
        if transport not in ("rgb", "yuv420"):
            raise ValueError("transport must be 'rgb' or 'yuv420'")
        if mesh is not None and int(batch_size) % mesh.size:
            raise ValueError(f"batch_size {batch_size} is not divisible by the {mesh.size} "
                             "devices of the mesh")
        self.transport = transport
        infer_fns = None
        if infer_fn is not None and not callable(infer_fn):
            infer_fns = list(infer_fn)
            if mesh is None or len(infer_fns) != mesh.size:
                raise ValueError("a sequence of infer_fn needs a mesh= of as many devices")
            self._infer = infer_fns[0]
        elif infer_fn is not None:
            self._infer = infer_fn
        elif transport == "yuv420":
            self._infer = make_camera_infer_fn_yuv(
                forward_eval, crop, compute_dtype=compute_dtype, batch=batch_size
            )
        else:
            self._infer = make_camera_infer_fn(
                forward_eval, compute_dtype=compute_dtype, batch=batch_size,
                host_downscale=True,
            )
        self._model = model
        if mesh is not None:
            devices = [resolve_device(d) for d in mesh.devices]
        else:
            if device is None:
                device = device_of(model) if model is not None else "cuda"
            devices = [resolve_device(device)]
        # (device, model, infer) a replica: replica 0 keeps the model where it
        # is on its device, every other replica gets its own copy (two
        # replicas on one card too)
        models = [model] * len(devices)
        if mesh is not None and model is not None:
            models = [model if k == 0 and device_of(model) == d else copy.deepcopy(model).to(d)
                      for k, d in enumerate(devices)]
        self._replicas = list(zip(devices, models, infer_fns or [self._infer] * len(devices)))
        self.device = devices[0]
        self.devices = devices
        self.batch_size = int(batch_size)
        self.max_delay = max_delay_ms / 1e3
        self.max_in_flight = int(max_in_flight)
        self.crop = int(crop)
        self.max_queue = int(max_queue)  # read by the recycling proxy
        self._requests: "queue.Queue" = queue.Queue(maxsize=max_queue)
        # bounded: put() blocking is the dispatcher's backpressure
        self._in_flight: "queue.Queue" = queue.Queue(maxsize=self.max_in_flight)
        self._cuda = self.device.type == "cuda"
        self._streams = None
        # pinned input buffers a replica, made at the first batch:
        # max_in_flight queued, one being built, one being fetched
        self._free_buffers = [queue.Queue() for _ in self._replicas]
        self._n_buffers = self.max_in_flight + 2
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._batches = 0
        self._images = 0
        self._consecutive_failures = 0
        self._occupancy_sum = 0.0
        self._latencies = deque(maxlen=2048)  # submit->resolve, seconds
        self._started = None
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._fetcher = threading.Thread(target=self._fetch_loop, daemon=True)

    # ---- client API ----------------------------------------------------

    def start(self) -> "BatchingInferenceServer":
        self._started = time.perf_counter()
        self._dispatcher.start()
        self._fetcher.start()
        return self

    def submit(self, frame: np.ndarray) -> Future:
        """Submit one RGB uint8 frame; returns a Future resolving to the
        probability vector (np.ndarray). Frames other than (crop, crop) are
        downscaled here, in the caller's thread (and packed to I420 there
        under the yuv420 transport)."""
        if self._stop.is_set():
            raise RuntimeError("server is stopped")
        frame = prepare_frame(frame, self.crop)
        if self.transport == "yuv420":
            frame = rgb_to_yuv420(frame)
        fut: Future = Future()
        t = time.perf_counter()
        fut._hst_submit_time = t  # read by the fetcher for latency stats
        self._requests.put((frame, fut, t))
        if self._stop.is_set() and fut.cancel():
            # raced a concurrent stop() and will never be processed: fail
            # now instead of leaving the Future to the client's timeout
            raise RuntimeError("server is stopped")
        return fut

    def _cancel_queued(self) -> None:
        try:
            while True:
                item = self._requests.get_nowait()
                if item is not None:
                    item[1].cancel()
        except queue.Empty:
            pass

    def stop(self, drain: bool = True):
        """Stop the server. With ``drain`` (default) everything already
        submitted is processed first; otherwise pending futures are
        cancelled. Safe on a server that was never started."""
        if self._started is None:
            self._stop.set()
            self._cancel_queued()
            return
        if not drain:
            self._stop.set()
        self._requests.put(None)  # sentinel: the dispatcher exits after the queue
        self._dispatcher.join()
        self._in_flight.put(None)
        self._fetcher.join()
        self._stop.set()
        # non-drain leftovers, or anything submitted after the sentinel
        self._cancel_queued()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)

    def health(self, max_consecutive_failures: int = 3) -> tuple:
        """(ok, reason): started, not stopped, both threads alive, and not
        ``max_consecutive_failures`` whole-batch errors in a row."""
        if self._started is None or self._stop.is_set():
            return False, "batcher not running"
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
            elapsed = (
                time.perf_counter() - self._started if self._started else 0.0
            )
            lats = sorted(self._latencies)

            def pct(p):
                if not lats:
                    return 0.0
                return lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3

            return {
                "batches": self._batches,
                "images": self._images,
                "mean_batch_occupancy": (
                    self._occupancy_sum / self._batches if self._batches else 0.0
                ),
                "throughput_imgs_per_sec": (
                    self._images / elapsed if elapsed > 0 else 0.0
                ),
                "latency_p50_ms": pct(0.50),
                "latency_p95_ms": pct(0.95),
            }

    # ---- internals -----------------------------------------------------

    def _collect_batch(self) -> Optional[tuple]:
        """Block for the first request, then fill up to batch_size or until
        the first request is max_delay old; an expired deadline still takes
        everything already queued (up to batch_size). Returns (frames,
        futures), or None at the shutdown sentinel."""
        item = self._requests.get()
        if item is None:
            return None
        frames: List[np.ndarray] = [item[0]]
        futures: List[Future] = [item[1]]
        deadline = item[2] + self.max_delay
        while len(frames) < self.batch_size:
            timeout = deadline - time.perf_counter()
            try:
                if timeout <= 0:  # deadline passed: take only what is ready
                    item = self._requests.get_nowait()
                else:
                    item = self._requests.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._requests.put(None)  # re-posted for the outer loop
                break
            frames.append(item[0])
            futures.append(item[1])
        return frames, futures

    @staticmethod
    def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None):
        """set_result/set_exception tolerant of a client's fut.cancel()."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:  # cancelled (InvalidStateError): the client gave up
            pass

    def _fail(self, futures: List[Future], exc: BaseException) -> None:
        for f in futures:
            self._resolve(f, exc=exc)
        with self._stats_lock:
            self._consecutive_failures += 1

    def _take_buffer(self, k: int, shape) -> torch.Tensor:
        """A free pinned uint8 buffer of replica ``k`` (its block's rows);
        the pools are made at the first batch, when the frame shape is
        known."""
        if self._n_buffers:
            for pool in self._free_buffers:
                for _ in range(self._n_buffers):
                    pool.put(torch.empty(shape, dtype=torch.uint8, pin_memory=True))
            self._n_buffers = 0
        return self._free_buffers[k].get()

    def _launch(self, frames: List[np.ndarray]):
        """Stack, upload and run one padded batch, a block a replica. On
        the card: returns (host probabilities being copied, the events
        after the copies, the input buffers); on the CPU the probabilities
        are final."""
        blocks = row_blocks(len(frames), len(self._replicas))
        if not self._cuda:
            x = torch.from_numpy(np.stack(frames))
            outs = [infer(model, x[sl]) for (_, model, infer), sl in zip(self._replicas, blocks)]
            return (outs[0] if len(outs) == 1 else torch.cat([o.cpu() for o in outs])), None, None
        host, events, bufs = None, [], []
        try:
            for k, ((dev, model, infer), sl) in enumerate(zip(self._replicas, blocks)):
                buf = self._take_buffer(k, (sl.stop - sl.start,) + frames[0].shape)
                bufs.append((k, buf))
                np.stack(frames[sl], out=buf.numpy())
                stream = self._streams[k]
                stream.wait_stream(torch.cuda.default_stream(dev))
                with torch.cuda.stream(stream):
                    out = infer(model, buf.to(dev, non_blocking=True))
                    if len(blocks) == 1 and not (torch.is_tensor(out)
                                                 and out.device.type == "cuda"):
                        host = out
                    else:
                        if host is None:
                            host = torch.empty((len(frames),) + tuple(out.shape[1:]),
                                               dtype=out.dtype, pin_memory=True)
                        host[sl].copy_(out, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(stream)
                    events.append(event)
        except BaseException:
            try:  # the uploads may be queued: let them finish before the buffers are reused
                for stream in self._streams:
                    stream.synchronize()
            finally:
                for k, buf in bufs:
                    self._free_buffers[k].put(buf)
            raise
        return host, events, bufs

    def _dispatch_loop(self):
        if self._cuda:
            if self.device.index is not None:  # a thread starts on card 0
                torch.cuda.set_device(self.device)
            # a stream a replica (replicas sharing a card get one each)
            self._streams = [torch.cuda.Stream(device=dev) for dev, _, _ in self._replicas]
        with torch.inference_mode():
            while not self._stop.is_set():
                batch = self._collect_batch()
                if batch is None:
                    break
                frames, futures = batch
                n = len(frames)
                if n < self.batch_size:
                    # pad with the first real frame: static shape, real data
                    frames = frames + [frames[0]] * (self.batch_size - n)
                try:
                    # stacked inside the guard: a residual per-frame anomaly
                    # fails this batch only, never the dispatcher thread
                    out, events, bufs = self._launch(frames)
                except Exception as e:  # a build, launch or CUDA error: fail the batch
                    self._fail(futures, e)
                    continue
                self._in_flight.put((out, events, bufs, futures, n))  # blocks = backpressure

    def _fetch_loop(self):
        while True:
            item = self._in_flight.get()
            if item is None:
                break
            out, events, bufs, futures, n = item
            try:
                for event in events or ():
                    event.synchronize()  # the batch's copies, and any late CUDA error
                probs = out.numpy() if torch.is_tensor(out) else np.asarray(out)
            except Exception as e:
                self._fail(futures, e)
                continue
            finally:
                for k, buf in bufs or ():
                    self._free_buffers[k].put(buf)
            now = time.perf_counter()
            lats = []
            for i, f in enumerate(futures):
                self._resolve(f, probs[i])
                t0 = getattr(f, "_hst_submit_time", None)
                if t0 is not None:
                    lats.append(now - t0)
            with self._stats_lock:
                self._batches += 1
                self._images += n
                self._consecutive_failures = 0  # the device path is healthy
                self._occupancy_sum += n / self.batch_size
                self._latencies.extend(lats)
