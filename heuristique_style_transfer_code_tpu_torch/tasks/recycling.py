"""Worker-process recycling for long-lived serving (``tasks/recycling.py`` of
the JAX package).

A serving deployment is split in two:

- a long-lived PARENT that owns the client surface (the HTTP server, the
  request Futures, the stats) and never touches the card:
  ``torch.cuda.is_initialized()`` stays False in it, and
- a spawned WORKER child that builds and runs an existing batching service
  unchanged (``BatchingInferenceServer`` or ``StyleTransferService``) and
  owns CUDA.

After ``recycle_after`` forwarded requests the parent sends the worker a
drain sentinel: the child's service answers everything already forwarded,
reports its final stats and exits, while new requests wait in the parent.
The parent then spawns a fresh worker, forwards the held requests in
submission order and carries on, with no request failing across the
handover. Memory the worker's process holds (host or device) goes back
with it. The context is ``spawn``: a forked child cannot use CUDA once the
parent has, and a spawned one starts from a clean interpreter.

The parent keeps each request's payload until its result arrives, so when
a worker crashes the unresolved requests are sent again to its successor
(application errors such as a malformed frame are results, never retried).
A worker never overlaps its successor: drain, exit, spawn.

Results cross the pipe as numpy arrays, bytes or plain Python values: a
torch tensor in a reply is copied to a numpy array in the child first (a
CUDA tensor would otherwise travel by CUDA IPC and die with the worker). A
reply that cannot be sent (one that does not pickle) resolves its Future
with an error and frees its window slot, rather than leaving the Future to
the client's timeout.
"""
from __future__ import annotations

import importlib
import multiprocessing as mp
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional

_STATS_PUSH_PERIOD_S = 1.0

# the window of requests outstanding in a worker whose builder does not
# report its inner queue bound (``max_queue`` in the ready info): small,
# so a small inner queue cannot fill and stall the child's pipe reader
UNKNOWN_QUEUE_WINDOW = 16


def strip_flag(argv: List[str], name: str) -> List[str]:
    """Remove ``name V`` / ``name=V`` occurrences from an argv list (the
    parent strips its own recycle flag before handing argv to the child)."""
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a == name:
            i += 2
            continue
        if a.startswith(name + "="):
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def _to_wire(value):
    """A reply as it crosses the pipe: a torch tensor as a numpy array on
    the host, anything else unchanged."""
    import torch

    return value.detach().cpu().numpy() if torch.is_tensor(value) else value


def _worker_main(conn, builder: str, argv: List[str]) -> None:
    """Child entry point (spawned: a fresh interpreter that owns CUDA).

    ``builder`` is a ``"module:function"`` spec; the function gets ``argv``
    and returns ``(service, info)``: ``service`` a started (and warmed)
    batching service with ``submit``/``stats``/``health``/``stop``, and
    ``info`` a small picklable dict of what the parent's HTTP layer needs
    (crop, class or style names, ...; ``max_queue``, the service's request
    queue bound, sizes the parent's window). The ready info adds
    ``worker_pid`` and ``build_s``, the builder's seconds (its imports, the
    model, the warmup).
    """
    import os

    t0 = time.perf_counter()
    try:
        mod_name, _, fn_name = builder.partition(":")
        build = getattr(importlib.import_module(mod_name), fn_name)
        service, info = build(list(argv))
    except BaseException as e:  # startup failure: report it, never hang the parent
        try:
            conn.send(("fatal", f"{type(e).__name__}: {e}"))
        finally:
            conn.close()
        raise
    send_lock = threading.Lock()

    def _send(msg) -> bool:
        """Send ``msg``; False when the parent is gone (the drain/EOF path
        below then exits). Pickling happens before any byte is written, so
        a message that does not pickle leaves the pipe intact and raises."""
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, EOFError):
                return False
        return True

    def _send_err(req_id: int, exc: BaseException) -> None:
        try:
            _send(("err", req_id, exc))
        except Exception:
            # an exception that does not pickle: degrade to a string
            _send(("err", req_id, RuntimeError(f"{type(exc).__name__}: {exc}")))

    def _send_result(req_id: int, fut: Future) -> None:
        # runs in the service's fetcher thread via add_done_callback
        exc = fut.exception()
        if exc is not None:
            _send_err(req_id, exc)
            return
        try:
            _send(("ok", req_id, _to_wire(fut.result())))
        except Exception as e:  # a reply that cannot be sent is an error reply
            _send_err(req_id, RuntimeError(
                f"the worker could not send its reply: {type(e).__name__}: {e}"))

    info = dict(info)
    info["worker_pid"] = os.getpid()
    info["build_s"] = time.perf_counter() - t0
    _send(("ready", info))

    push_stop = threading.Event()

    def _push_stats() -> None:
        while not push_stop.wait(_STATS_PUSH_PERIOD_S):
            try:
                if not _send(("stats", service.stats(), tuple(service.health()))):
                    return
            except Exception:
                return

    threading.Thread(target=_push_stats, daemon=True).start()

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            msg = ("drain",)  # parent died: drain what we have and exit
        if msg[0] == "drain":
            break
        _, req_id, (args, kwargs) = msg
        try:
            fut = service.submit(*args, **kwargs)
        except Exception as e:  # a validation error: a result, never retried
            _send_err(req_id, e)
            continue
        fut.add_done_callback(lambda f, rid=req_id: _send_result(rid, f))
    push_stop.set()
    service.stop(drain=True)  # resolves every outstanding Future first
    _send(("bye", service.stats()))
    conn.close()


def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None):
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except Exception:  # cancelled: the client gave up
        pass


class RecyclingServiceProxy:
    """Stand-in for a batching service that recycles its worker.

    Presents the surface the HTTP front ends consume (``submit(...) ->
    Future``, ``stats()``, ``health()``/``healthy()``, ``stop()``, and the
    attributes of the worker's ``info`` dict such as ``crop`` or
    ``style_names``) while the service itself lives in a spawned child.

    Parameters
    ----------
    builder : ``"module:function"`` spec run in the child; returns
        ``(started_service, info_dict)``. The parent never imports it.
    argv : argument list handed to the builder (the serve CLI's own argv
        without the recycle flag, so the child rebuilds the same service).
    recycle_after : forward this many requests to a worker, then drain and
        respawn it. 0 disables recycling (the proxy still isolates the
        service in a child and survives worker crashes).
    preprocess_factory : optional ``info -> fn(*args, **kwargs) -> (args,
        kwargs)``, built once after the first worker reports ready; runs
        in the submitting caller's thread, so validation raises there
        (the in-process service's 400-vs-503 split) and the downscale
        spreads over client threads.
    start_timeout : seconds to wait for a worker to report ready.
    max_pending : ``submit`` blocks while this many requests are
        unresolved (forwarded or held).
    max_in_worker : cap on requests outstanding inside the worker. It must
        stay at or below the inner service's request queue bound: were
        that queue to fill, the child's pipe reader would stop draining
        the pipe, the parent's ``conn.send`` would block holding the
        proxy lock, and stats()/health() would wait behind the device.
        The window is clamped to the ``max_queue`` of the ready info, and
        to ``UNKNOWN_QUEUE_WINDOW`` when the info does not give one.
    max_consecutive_crashes : after this many worker crashes with no
        successful result in between, the proxy fails every outstanding
        Future, reports unhealthy and rejects new submissions.
    """

    def __init__(
        self,
        builder: str,
        argv: List[str],
        *,
        recycle_after: int = 0,
        preprocess_factory: Optional[Callable] = None,
        start_timeout: float = 900.0,
        max_pending: int = 1024,
        max_in_worker: int = 384,
        max_consecutive_crashes: int = 3,
    ):
        self._builder = builder
        self._argv = list(argv)
        self._recycle_after = int(recycle_after)
        self._preprocess_factory = preprocess_factory
        self._preprocess: Optional[Callable] = None
        self._start_timeout = float(start_timeout)
        self._max_pending = int(max_pending)
        self._max_in_worker = int(max_in_worker)
        self._in_worker = 0
        self._lock = threading.Lock()
        self._room = threading.Condition(self._lock)
        self._pending: dict = {}  # req_id -> (Future, payload)
        self._hold: deque = deque()  # req_ids awaiting a live worker
        self._next_id = 0
        self._sent_since_spawn = 0
        self._draining = False
        self._stopping = False
        self._stopped = threading.Event()
        self._conn = None
        self._proc = None
        self._reader: Optional[threading.Thread] = None
        self._started = None
        self._latencies: deque = deque(maxlen=2048)
        self._resolved = 0
        self._errors = 0
        self._recycles = 0
        self._crashes = 0
        self._max_consecutive_crashes = int(max_consecutive_crashes)
        self._consecutive_crashes = 0
        self._failed: Optional[str] = None
        # summed final child stats across completed workers
        self._acc = {"batches": 0, "images": 0, "jobs": 0,
                     "occupancy_sum": 0.0, "iters_sum": 0.0, "size_hist": {}}
        self._live_stats: dict = {}
        self._live_health = (True, "ok")
        self.info: dict = {}

    # ---- client API ----------------------------------------------------

    def start(self) -> "RecyclingServiceProxy":
        self._started = time.perf_counter()
        self._spawn()  # raises if the first worker cannot start
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        return self

    def submit(self, *args, **kwargs) -> Future:
        if self._stopping:
            raise RuntimeError(self._failed or "server is stopped")
        if self._preprocess is not None:
            args, kwargs = self._preprocess(*args, **kwargs)
        fut: Future = Future()
        fut._hst_submit_time = time.perf_counter()
        payload = (args, kwargs)
        with self._lock:
            while len(self._pending) >= self._max_pending and not self._stopping:
                self._room.wait()  # backpressure: block the caller
            if self._stopping:
                raise RuntimeError(self._failed or "server is stopped")
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = (fut, payload)
            if (
                self._conn is not None
                and not self._draining
                and not self._hold
                and self._in_worker < self._max_in_worker
            ):
                self._send_request_locked(rid, payload)
            else:  # handover in progress or the worker's window is full
                self._hold.append(rid)
        return fut

    def stop(self, drain: bool = True):
        """Stop. With ``drain`` everything already submitted resolves first
        (requests held across a handover too); otherwise held requests are
        cancelled and only those in the worker resolve."""
        with self._lock:
            self._stopping = True
            self._room.notify_all()  # wake blocked submitters to the error
            if not drain:
                while self._hold:
                    rid = self._hold.popleft()
                    ent = self._pending.pop(rid, None)
                    if ent is not None:
                        ent[0].cancel()
            # forward what the window allows; the reader goes on as results
            # arrive and sends the drain sentinel once the hold is empty
            self._flush_hold_locked()
            if self._conn is None and not self._hold and not self._pending:
                self._stopped.set()
        if self._started is None:
            self._stopped.set()
            return
        self._stopped.wait(timeout=self._start_timeout)
        if self._reader is not None:
            self._reader.join(timeout=10.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)

    def health(self, max_consecutive_failures: int = 3) -> tuple:
        if self._failed:
            return False, self._failed
        if self._started is None or self._stopping:
            return False, "batcher not running"
        if self._reader is None or not self._reader.is_alive():
            return False, "worker thread dead"
        with self._lock:
            conn, draining = self._conn, self._draining
            ok, reason = self._live_health
        if conn is None or draining:
            # handover in progress: requests wait and will be served
            return True, "recycling worker"
        if not ok:
            return False, reason
        return True, "ok"

    def healthy(self, max_consecutive_failures: int = 3) -> bool:
        return self.health(max_consecutive_failures)[0]

    def stats(self) -> dict:
        with self._lock:
            live = dict(self._live_stats)
            acc = {k: (dict(v) if isinstance(v, dict) else v) for k, v in self._acc.items()}
            lats = sorted(self._latencies)
            resolved = self._resolved
            elapsed = time.perf_counter() - self._started if self._started else 0.0
            extras = {
                "recycles": self._recycles,
                "worker_crashes": self._crashes,
                "requests": self._next_id,
                "pending": len(self._pending),
                "worker_pid": self.info.get("worker_pid"),
            }
        # count_key names the service's flavour ("images" for the
        # classification batcher, "jobs" for the style service), so the
        # stats carry the keys /stats and /metrics read from the start
        count_key = self.info.get("count_key", "images")
        lb = live.get("batches", 0)
        total_b = acc["batches"] + lb
        out = {
            "batches": total_b,
            # the parent's own count of resolved requests, exact the instant
            # a Future resolves (each ok-result is one image or job)
            count_key: resolved,
            "mean_batch_occupancy": (
                (acc["occupancy_sum"] + live.get("mean_batch_occupancy", 0.0) * lb) / total_b
                if total_b else 0.0
            ),
        }
        if count_key == "jobs":
            out["mean_iterations"] = (
                (acc["iters_sum"] + live.get("mean_iterations", 0.0) * lb) / total_b
                if total_b else 0.0
            )
            hist = dict(acc["size_hist"])
            for k, v in live.get("batch_size_hist", {}).items():
                hist[k] = hist.get(k, 0) + v
            out["batch_size_hist"] = {k: hist[k] for k in sorted(hist)}
        if "transport" in live or "transport" in self.info:
            out["transport"] = live.get("transport", self.info.get("transport"))

        # rate and latency from the parent's own ledger: they include the
        # handover's waiting, which is what a client sees
        def pct(p):
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3

        rate = resolved / elapsed if elapsed > 0 else 0.0
        out["jobs_per_sec" if count_key == "jobs" else "throughput_imgs_per_sec"] = rate
        out["latency_p50_ms"] = pct(0.50)
        out["latency_p95_ms"] = pct(0.95)
        out.update(extras)
        return out

    # ---- internals -----------------------------------------------------

    def _send_request_locked(self, rid: int, payload) -> bool:
        """Forward one request to the live worker. On a broken pipe (the
        worker just crashed; the reader will respawn it) the request goes
        back on hold instead of failing its client."""
        try:
            self._conn.send(("req", rid, payload))
        except Exception:
            self._hold.append(rid)
            return False
        self._sent_since_spawn += 1
        self._in_worker += 1
        if (
            self._recycle_after
            and self._sent_since_spawn >= self._recycle_after
            and not self._draining
        ):
            self._draining = True
            try:
                self._conn.send(("drain",))
            except Exception:
                pass  # crash path: the reader respawns, the counter resets anyway
        return True

    def _flush_hold_locked(self) -> None:
        """Forward held requests in submission order while the worker has
        window room; once stopping and nothing is left to forward, send the
        final drain sentinel. Every send is window-bounded, so the child's
        pipe reader drains promptly and ``conn.send`` never blocks long
        under this lock."""
        while (
            self._hold
            and self._conn is not None
            and not self._draining
            and self._in_worker < self._max_in_worker
        ):
            rid = self._hold.popleft()
            ent = self._pending.get(rid)
            if ent is None:  # cancelled while held
                continue
            if not self._send_request_locked(rid, ent[1]):
                # the failed send re-appended rid at the tail: restore the
                # order and let the crash path respawn
                self._hold.pop()
                self._hold.appendleft(rid)
                break
        if self._stopping and self._conn is not None and not self._draining and not self._hold:
            self._draining = True
            try:
                self._conn.send(("drain",))
            except Exception:
                pass

    def _spawn(self) -> None:
        """Spawn a worker, block until it reports ready, then forward held
        requests in submission order. Called from start() and (on a recycle
        or a crash) from the reader thread, never concurrently."""
        ctx = mp.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(target=_worker_main, args=(child_conn, self._builder, self._argv),
                           daemon=True)
        proc.start()
        child_conn.close()
        deadline = time.monotonic() + self._start_timeout
        while not parent_conn.poll(0.5):
            if not proc.is_alive():
                raise RuntimeError(
                    f"serving worker died during startup (exit code {proc.exitcode})")
            if time.monotonic() > deadline:
                proc.kill()
                raise RuntimeError(f"serving worker not ready within {self._start_timeout}s")
        msg = parent_conn.recv()
        if msg[0] != "ready":
            proc.join(timeout=10.0)
            raise RuntimeError(f"serving worker failed to start: {msg[1]}")
        with self._lock:
            self.info = msg[1]
            # never outrun the inner queue (see max_in_worker); a builder
            # that does not report it gets the small window
            self._max_in_worker = min(
                self._max_in_worker, int(self.info.get("max_queue", UNKNOWN_QUEUE_WINDOW)))
            if self._preprocess_factory is not None and self._preprocess is None:
                self._preprocess = self._preprocess_factory(self.info)
            for k, v in self.info.items():
                # expose crop, style_names, ... for the HTTP layers
                if not hasattr(type(self), k) and not k.startswith("_"):
                    setattr(self, k, v)
            self._conn = parent_conn
            self._proc = proc
            self._sent_since_spawn = 0
            self._in_worker = 0
            self._draining = False
            self._live_stats = {}
            self._live_health = (True, "ok")
            # windowed flush; when stopping, it sends the final drain itself
            self._flush_hold_locked()

    def _accumulate(self, final_stats: dict) -> None:
        b = final_stats.get("batches", 0)
        with self._lock:
            self._acc["batches"] += b
            for k in ("images", "jobs"):
                self._acc[k] += final_stats.get(k, 0)
            self._acc["occupancy_sum"] += final_stats.get("mean_batch_occupancy", 0.0) * b
            self._acc["iters_sum"] += final_stats.get("mean_iterations", 0.0) * b
            for k, v in final_stats.get("batch_size_hist", {}).items():
                self._acc["size_hist"][k] = self._acc["size_hist"].get(k, 0) + v

    def _on_child_gone(self, expected: bool) -> None:
        with self._lock:
            conn, proc = self._conn, self._proc
            self._conn = None
            self._proc = None
            self._live_stats = {}
            self._live_health = (True, "ok")
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
        if proc is not None:
            proc.join(timeout=60.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10.0)
        give_up = False
        with self._lock:
            if expected:
                self._consecutive_crashes = 0
                if not self._stopping:
                    self._recycles += 1
            else:
                self._crashes += 1
                self._consecutive_crashes += 1
                crash_streak = self._consecutive_crashes
                give_up = crash_streak >= self._max_consecutive_crashes
                # the requests in flight in the dead child: queued again for
                # its successor (ids are monotonic, so sorting restores the
                # submission order)
                held = set(self._hold)
                self._hold = deque(sorted(
                    list(self._hold) + [r for r in self._pending if r not in held]))
            stopping = self._stopping
            work_left = bool(self._hold) or bool(self._pending)
        if give_up:
            # a request or backlog that kills every worker: stop replaying,
            # fail the outstanding Futures, report unhealthy, refuse new work
            reason = (f"serving worker crashed {crash_streak} times "
                      "in a row with no successful result; giving up")
            with self._lock:
                self._failed = reason
                self._stopping = True
                leftovers = list(self._pending.items())
                self._pending.clear()
                self._hold.clear()
                self._room.notify_all()
            for _, (fut, _p) in leftovers:
                _resolve(fut, exc=RuntimeError(reason))
            self._stopped.set()
            return
        if stopping and not work_left:
            self._stopped.set()
            return
        # anything left (held, or replayed after a crash) gets a fresh
        # worker, even mid-stop, so the drain still answers it
        try:
            self._spawn()
        except Exception as e:
            with self._lock:
                leftovers = list(self._pending.items())
                self._pending.clear()
                self._hold.clear()
                self._stopping = True
                self._room.notify_all()
            for _, (fut, _p) in leftovers:
                _resolve(fut, exc=RuntimeError(f"serving worker could not be respawned: {e}"))
            self._stopped.set()

    def _read_loop(self) -> None:
        while True:
            with self._lock:
                conn = self._conn
                stopping = self._stopping
            if conn is None:
                if stopping:
                    self._stopped.set()
                    return
                time.sleep(0.05)
                continue
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                self._on_child_gone(expected=False)
                continue
            kind = msg[0]
            if kind in ("ok", "err"):
                rid = msg[1]
                with self._lock:
                    ent = self._pending.pop(rid, None)
                    if ent is not None:
                        self._in_worker -= 1
                    self._consecutive_crashes = 0  # the worker made progress
                    self._room.notify()
                    self._flush_hold_locked()
                if ent is None:
                    continue
                fut = ent[0]
                if kind == "ok":
                    _resolve(fut, msg[2])
                    t0 = getattr(fut, "_hst_submit_time", None)
                    with self._lock:
                        self._resolved += 1
                        if t0 is not None:
                            self._latencies.append(time.perf_counter() - t0)
                else:
                    exc = (msg[2] if isinstance(msg[2], BaseException)
                           else RuntimeError(str(msg[2])))
                    _resolve(fut, exc=exc)
                    with self._lock:
                        self._errors += 1
            elif kind == "stats":
                with self._lock:
                    self._live_stats = msg[1]
                    self._live_health = tuple(msg[2])
            elif kind == "bye":
                self._accumulate(msg[1])
                self._on_child_gone(expected=True)
