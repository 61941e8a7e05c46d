"""Dynamic request batching for serving on one CUDA device.

Throughput comes from batched dispatch (one forward over [B, ...]), but
serving traffic arrives one utterance at a time. The batcher bridges the
two: requests queue from any number of frontend threads, a single device
thread drains the queue, groups compatible requests, and runs bucketed
batched dispatches through the pipeline (``models/pipeline.py``). The
device thread is the only thread that touches the card, so all device work
goes in order onto one CUDA stream from one thread: no lock contention on
the device, and no cross-thread stream ordering to get wrong.

Batching policy: take whatever is queued (up to the effective batch); if
the queue is empty and a request just arrived, wait up to ``max_wait_ms``
for company before dispatching. Under load the wait never triggers (the
queue is always non-empty), so its latency cost is bounded by one batch's
compute. The effective batch adapts to load: sustained queue depth doubles
it from ``max_batch`` toward ``max_batch_limit``, and light traffic decays
it back for small-batch latency. Long inputs chunk at sentence boundaries
(``TTSPipeline._chunk_long_text``) and re-join with silence gaps; device
work is sliced to at most the effective batch per dispatch and each slice
pads up to a power-of-two batch bucket, so the set of shapes stays small
and warmup covers it.

Seeded requests dispatch alone (never co-batched): a request's waveform
must be reproducible from (text, seed), so it cannot depend on whatever
traffic happened to share its batch.

A pipeline with an ``idle()`` method (``serve/mesh.MeshLeader``) has it
called on the device thread every 0.1 s the queue stays empty.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)


class ServerOverloadedError(RuntimeError):
    """Raised by :meth:`DynamicBatcher.submit` when the request queue is at
    its depth limit — backpressure, mapped to HTTP 503 by the server. Under
    sustained overload, rejecting at admission keeps latency bounded for
    the requests already queued instead of growing the queue (and every
    request's wait) without limit."""


class ServerStoppedError(RuntimeError):
    """Raised for requests that hit a stopping/stopped batcher — a
    draining replica, not a fault. The server maps this to a retryable
    503."""


def _fail(fut: "Future", exc: BaseException) -> None:
    """set_exception tolerant of already-resolved futures (shutdown races)."""
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


@dataclass
class BatchItem:
    """One queued synthesis request."""

    text: str
    future: "Future[np.ndarray]"
    temperature: float = 1.0
    seed: Optional[int] = None
    enqueued_at: float = field(default_factory=time.monotonic)
    # sentence chunks, precomputed on the frontend thread at submit()
    chunks: Optional[List[str]] = None


@dataclass
class _DeviceTask:
    """Work handed to the device thread by another thread (``warmup()``):
    the device thread runs ``fn`` between collects and resolves
    ``future`` with its result."""

    fn: Callable[[], Any]
    future: "Future[Any]"


class DynamicBatcher:
    """Groups queued requests and drives the pipeline on one device thread.

    Args:
        pipeline: a ready :class:`iris_tts_tpu_torch.models.pipeline.
            TTSPipeline` (its ``device`` decides where the work runs), or
            an :class:`iris_tts_tpu_torch.serve.export.AotPipeline`.
        max_batch: most rows per device dispatch under light load (requests
            expand into chunks; slices never exceed the current effective
            batch).
        max_batch_limit: adaptive growth ceiling. When a collect fills the
            whole effective batch and requests are still queued, the
            effective batch doubles (up to this limit); when collects come
            in at under a quarter of it, it halves back toward
            ``max_batch``. Queue depth should buy batch size, not wait
            time. Default None = ``max_batch`` (no growth).
        max_wait_ms: how long a lone request waits for company.
        gap_ms: silence between a long request's re-joined chunks.
        max_chunks_per_request: admission cap — a request that would expand
            past this many chunks is rejected at submit() (bounds the
            device time one request can take).
        pcm16_transfer: quantize to int16 on the device before the copy to
            the host (half the bytes; waveforms resolve as int16).
        max_queue: queue-depth admission limit (see ServerOverloadedError).

    A stopped batcher cannot restart (create a new one): restart-after-stop
    would race the drain logic for queued futures.
    """

    def __init__(self, pipeline, max_batch: int = 8,
                 max_wait_ms: float = 5.0, gap_ms: float = 120.0,
                 max_chunks_per_request: int = 64,
                 pcm16_transfer: bool = False,
                 max_queue: int = 256,
                 max_batch_limit: Optional[int] = None):
        self._pipe = pipeline
        self._pcm16 = pcm16_transfer
        self._max_batch = max(1, max_batch)
        self._max_batch_limit = max(
            self._max_batch, max_batch_limit or self._max_batch
        )
        # Effective dispatch cap, adapted between max_batch and the limit
        # by _adapt_batch(). Only the device thread mutates it.
        self._eff_batch = self._max_batch
        self._max_wait_s = max_wait_ms / 1000.0
        self._gap_ms = gap_ms
        self._max_chunks = max_chunks_per_request
        # The queue itself stays unbounded so stop()'s sentinel never
        # blocks; submit() enforces the limit.
        self._max_queue = max(1, max_queue)
        self.n_rejected = 0
        # Serializes the admission check-then-put and the rejection counter
        # across HTTP handler threads (one per connection); without it N
        # racing admits can overshoot the limit and concurrent rejects lose
        # counter increments.
        self._admission_lock = threading.Lock()
        self._queue: "queue.Queue[Union[BatchItem, _DeviceTask, None]]" = (
            queue.Queue())
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._stopping = threading.Event()
        # batch buckets: powers of two up to the growth limit (the pipeline
        # pads rows, outputs trim back)
        self._batch_buckets = []
        b = 1
        while b < self._max_batch_limit:
            self._batch_buckets.append(b)
            b *= 2
        self._batch_buckets.append(self._max_batch_limit)
        # stats (mutated by the device thread; _lat_lock guards the deques
        # and the histogram against concurrent /stats readers)
        self.n_requests = 0
        self.n_batches = 0
        self.n_warmed = 0  # shapes run by start()'s warmup
        self.warmup_s = 0.0
        self.batch_size_hist: Dict[int, int] = {}
        self._lat_lock = threading.Lock()
        self._latencies = collections.deque(maxlen=1024)  # seconds
        # time-to-first-audio of streaming requests (server.py reports the
        # moment the first chunk hits the wire)
        self._ttfas = collections.deque(maxlen=1024)  # seconds

    # -- frontend side ------------------------------------------------------

    def submit(self, text: str, temperature: float = 1.0,
               seed: Optional[int] = None,
               chunks: Optional[List[str]] = None,
               bypass_admission: bool = False) -> "Future[np.ndarray]":
        """Queue one utterance; resolves to a 1-D float32 waveform (int16
        with ``pcm16_transfer``).

        Raises in the caller (not the device thread) on bad arguments or
        over-limit text, so poison requests can never kill the server.
        ``chunks`` lets a streaming caller pass already-computed sentence
        chunks so the frontend G2P does not run twice.

        ``bypass_admission`` exempts the put from the queue-depth limit —
        for continuation chunks of an already-admitted streaming request:
        admission control gates request starts; 503-ing a request halfway
        through its stream would truncate audio the client already
        committed to (the chunk count is still bounded per request by
        ``max_chunks_per_request``).
        """
        if self._stopping.is_set():
            raise ServerStoppedError("batcher is stopped")
        temperature = float(temperature)
        if seed is not None:
            seed = int(seed)
        if chunks is None:
            chunks = self.chunk_text(text)
        fut: "Future[np.ndarray]" = Future()
        item = BatchItem(str(text), fut, temperature, seed, chunks=chunks)
        with self._admission_lock:
            if (not bypass_admission
                    and self._queue.qsize() >= self._max_queue):
                self.n_rejected += 1
                raise ServerOverloadedError(
                    f"request queue at its {self._max_queue}-request "
                    "limit; retry later"
                )
            self._queue.put(item)
        if self._stopping.is_set():
            # stop() may already have drained the queue past our put.
            _fail(fut, ServerStoppedError("server shutdown"))
        return fut

    def synthesize(self, text: str, timeout: Optional[float] = 60.0,
                   temperature: float = 1.0,
                   seed: Optional[int] = None) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(text, temperature, seed).result(timeout=timeout)

    def chunk_text(self, text: str) -> List[str]:
        """The batcher's sentence chunking, exposed for streaming callers
        (same admission cap as submit())."""
        chunks = self._pipe._chunk_long_text(
            str(text), self._pipe.phoneme_buckets[-1]
        ) or [""]
        if len(chunks) > self._max_chunks:
            raise ValueError(
                f"text expands to {len(chunks)} chunks, over the "
                f"max_chunks_per_request={self._max_chunks} admission limit"
            )
        return chunks

    def warmup(self) -> int:
        """Run every shape live traffic can reach once, on the device
        thread, and return the number of shapes run. :meth:`start` already
        does this before it returns; call it again to re-warm a running
        batcher. From any other thread the work is handed to the device
        thread and this waits for it: PyTorch keeps cuDNN's per-shape
        execution plans per thread, so shapes warmed elsewhere would still
        be cold where requests run. Raises before :meth:`start` (there is
        no device thread yet) and after :meth:`stop`."""
        if threading.current_thread() is self._thread:
            return self._warmup()
        if not self._started:
            raise RuntimeError(
                "the batcher warms up on its device thread: call start(), "
                "which runs the warmup there")
        if self._stopping.is_set():
            raise ServerStoppedError("batcher is stopped")
        fut: "Future[int]" = Future()
        self._queue.put(_DeviceTask(self._warmup, fut))
        return fut.result()

    def _warmup(self) -> int:
        """The warmup itself (:meth:`warmup`). A live pipeline
        runs every fused (phoneme, frame) bucket pair (the path single-row
        groups take), then every (batch, phoneme, frame) bucket of the
        two-stage path at this batcher's batch buckets, in the transfer
        format it dispatches. A pipeline without those (an ahead-of-time
        ``serve.export.AotPipeline``) runs its own ``warmup()``. Returns
        the number of shapes run. Call it on the device thread only."""
        pipe = self._pipe
        if not hasattr(pipe, "warmup_fused"):
            return int(pipe.warmup() or 0)
        n = pipe.warmup_fused(pcm16=self._pcm16)
        if hasattr(pipe, "warmup_batched"):
            n += pipe.warmup_batched(self._batch_buckets, pcm16=self._pcm16)
        return n

    def healthy(self) -> bool:
        """True while the device thread is alive and accepting work."""
        return (
            self._thread is not None
            and self._thread.is_alive()
            and not self._stopping.is_set()
        )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DynamicBatcher":
        """Start the device thread. It first runs every serving shape once
        (:meth:`warmup`) and this returns once that is done (the count is
        in ``n_warmed``, the seconds in ``warmup_s``); a warmup failure is
        raised here and leaves the batcher stopped."""
        if self._started:
            raise RuntimeError(
                "batcher already started (stopped batchers cannot restart "
                "— create a new DynamicBatcher)"
            )
        self._started = True
        ready = threading.Event()
        failed: List[BaseException] = []
        self._thread = threading.Thread(
            target=self._run, args=(ready, failed),
            name="tts-batcher", daemon=True,
        )
        self._thread.start()
        ready.wait()
        if failed:
            raise RuntimeError("batcher warmup failed") from failed[0]
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain-stop: queued requests still complete."""
        if self._thread is None:
            return
        self._stopping.set()
        self._queue.put(None)  # wake the device thread
        self._thread.join(timeout=timeout)
        # Fail anything still queued after the drain window.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _fail(item.future, ServerStoppedError("server shutdown"))

    def __enter__(self) -> "DynamicBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- device thread ------------------------------------------------------

    def _collect(self) -> List[BatchItem]:
        """Block for the first request, then take whatever else is queued
        (waiting up to max_wait for company if alone)."""
        items: List[BatchItem] = []
        idle = getattr(self._pipe, "idle", None)  # serve --mesh's heartbeat
        while True:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._stopping.is_set():
                    return items
                if idle is not None:
                    idle()
                continue
            if first is None:  # shutdown sentinel
                return items
            if isinstance(first, _DeviceTask):
                self._run_task(first)
                continue
            items.append(first)
            break
        deadline = time.monotonic() + self._max_wait_s
        while len(items) < self._eff_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # keep the sentinel for the outer loop
                break
            if isinstance(nxt, _DeviceTask):
                self._run_task(nxt)
                continue
            items.append(nxt)
        return items

    @staticmethod
    def _run_task(task: _DeviceTask) -> None:
        try:
            task.future.set_result(task.fn())
        except Exception as e:  # noqa: BLE001 — raised in the caller
            task.future.set_exception(e)

    def _adapt_batch(self, n_rows: int) -> None:
        """Adaptive effective batch: a row-saturated collect with more work
        still queued doubles the dispatch cap toward ``max_batch_limit`` —
        the device trades per-request latency it is not delivering anyway
        (the work would sit in the queue) for the throughput of bigger
        batches. Light collects decay it back so light traffic keeps
        small-batch latency. Load is measured in device rows (chunks), the
        unit the cap bounds — item count would undercount chunk-heavy
        traffic and never grow."""
        if n_rows >= self._eff_batch and not self._queue.empty():
            grown = min(self._eff_batch * 2, self._max_batch_limit)
            if grown != self._eff_batch:
                self._eff_batch = grown
                logger.info("queue depth %d: effective batch -> %d",
                            self._queue.qsize(), grown)
        elif n_rows * 4 <= self._eff_batch:
            self._eff_batch = max(self._eff_batch // 2, self._max_batch)

    def _run(self, ready: threading.Event,
             failed: List[BaseException]) -> None:
        # Autograd's mode is thread-local: without this the device thread
        # would record graphs for every dispatch it makes.
        with torch.inference_mode():
            try:
                t0 = time.monotonic()
                self.n_warmed = self._warmup()
                self.warmup_s = time.monotonic() - t0
            except Exception as e:  # noqa: BLE001 — raised by start()
                logger.exception("warmup failed")
                failed.append(e)
                self._stopping.set()
                return
            finally:
                ready.set()
            self._serve_loop()

    def _serve_loop(self) -> None:
        while not (self._stopping.is_set() and self._queue.empty()):
            items = self._collect()
            self._adapt_batch(sum(
                len(it.chunks) if it.chunks else 1 for it in items
            ))
            if not items:
                continue
            # Seeded requests dispatch alone (reproducibility contract);
            # unseeded ones group by temperature (one scalar for the whole
            # batch).
            groups: List[List[BatchItem]] = []
            by_temp: Dict[float, List[BatchItem]] = {}
            for it in items:
                if it.seed is not None:
                    groups.append([it])
                else:
                    by_temp.setdefault(it.temperature, []).append(it)
            groups.extend(by_temp.values())
            for group in groups:
                # A failure anywhere must fail that group's futures, never
                # the device thread — a dead thread would hang the server.
                try:
                    self._dispatch(group)
                except Exception as e:  # noqa: BLE001
                    for it in group:
                        _fail(it.future, e)
                    logger.exception("dispatch of %d failed", len(group))

    def _pad_to_bucket(self, flat: List[str]) -> List[str]:
        for b in self._batch_buckets:
            if len(flat) <= b:
                return flat + [flat[-1]] * (b - len(flat))
        return flat

    def _dispatch(self, group: List[BatchItem]) -> None:
        flat: List[str] = []
        per_item_chunks: List[int] = []
        for it in group:
            chunks = it.chunks or [it.text]
            per_item_chunks.append(len(chunks))
            flat.extend(chunks)
        if len(flat) == 1:
            # Single-utterance group (a seeded request, a streaming chunk,
            # or light traffic): the fused path needs no host read of the
            # predicted frame total before stage B, so it is one sync
            # instead of two. Rows compressed beyond the pipeline's
            # fused_overflow_tolerance are redone two-stage inside
            # synthesize().
            it = group[0]
            audio = self._pipe.synthesize(
                flat[0], temperature=it.temperature, seed=it.seed,
                fused=True, pcm16=self._pcm16,
            )
            self.n_batches += 1
            self.n_requests += 1
            with self._lat_lock:
                self.batch_size_hist[1] = self.batch_size_hist.get(1, 0) + 1
                self._latencies.append(time.monotonic() - it.enqueued_at)
            try:
                it.future.set_result(audio)
            except InvalidStateError:
                pass
            return
        # Bounded device work: at most the effective batch of rows per
        # dispatch, each slice padded to a power-of-two batch bucket
        # (duplicate rows are synthesized and dropped, so only warmed
        # shapes run). Where the pipeline has the dispatch/collect split
        # (TTSPipeline), slice N+1 is dispatched before slice N is
        # collected. Otherwise (AotPipeline, whose CUDA-graph outputs the
        # next replay overwrites) each slice is synthesized and copied to
        # the host before the next one starts.
        outs: List[np.ndarray] = []
        split = hasattr(self._pipe, "_batched_dispatch")
        pending = None  # (handle, real_rows)

        def flush(handle):
            if handle is not None:
                outs.extend(
                    self._pipe._batched_collect(handle[0])[: handle[1]]
                )

        cap = self._eff_batch
        for lo in range(0, len(flat), cap):
            part = flat[lo:lo + cap]
            padded = self._pad_to_bucket(part)
            kw = dict(temperature=group[0].temperature, seed=group[0].seed,
                      pcm16=self._pcm16)
            if split:
                handle = self._pipe._batched_dispatch(padded, **kw)
            else:
                outs.extend(self._pipe.synthesize(padded, fused=False,
                                                  **kw)[: len(part)])
            self.n_batches += 1
            with self._lat_lock:
                self.batch_size_hist[len(padded)] = (
                    self.batch_size_hist.get(len(padded), 0) + 1
                )
            if split:
                flush(pending)
                pending = (handle, len(part))
        flush(pending)
        self.n_requests += len(group)
        now = time.monotonic()
        pos = 0
        for gi, it in enumerate(group):
            n = per_item_chunks[gi]
            joined = self._pipe.join_chunks(
                outs[pos:pos + n], gap_ms=self._gap_ms
            )
            pos += n
            with self._lat_lock:
                self._latencies.append(now - it.enqueued_at)
            try:
                it.future.set_result(joined)
            except InvalidStateError:
                pass  # failed at shutdown after we computed it; drop

    # -- observability ------------------------------------------------------

    def record_ttfa(self, seconds: float) -> None:
        """Record one streaming request's time-to-first-audio (called by
        the HTTP layer when the first PCM chunk is written)."""
        with self._lat_lock:
            self._ttfas.append(seconds)

    def stats(self) -> Dict:
        with self._lat_lock:
            lats = sorted(self._latencies)
            ttfas = sorted(self._ttfas)
            # under the lock: the device thread inserts new keys mid-run
            # and dict iteration would raise on a concurrent resize
            hist = dict(sorted(self.batch_size_hist.items()))

        def _pct_of(seq, p):
            return (
                round(1000 * seq[min(len(seq) - 1, int(p * len(seq)))], 2)
                if seq else None
            )

        def pct(p):
            return _pct_of(lats, p)
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "queue_depth": self._queue.qsize(),
            "effective_batch": self._eff_batch,
            "rejected": self.n_rejected,
            "mean_batch_size": (
                self.n_requests / self.n_batches if self.n_batches else 0.0
            ),
            "batch_size_hist": hist,
            "latency_ms": {"p50": pct(0.50), "p95": pct(0.95),
                           "p99": pct(0.99), "max": pct(1.0)},
            # Streaming time-to-first-audio (first chunk on the wire).
            "ttfa_ms": {"p50": _pct_of(ttfas, 0.50),
                        "p95": _pct_of(ttfas, 0.95),
                        "max": _pct_of(ttfas, 1.0)},
            # Fused-path frame-budget compressions on the pipeline
            # (utterances whose predicted durations overflowed
            # fused_frames_per_phoneme and were rate-compressed) ...
            "fused_overflows": getattr(self._pipe, "fused_overflow_count",
                                       0),
            # ... of which, rows beyond fused_overflow_tolerance that were
            # re-synthesized on the two-stage path.
            "fused_fallbacks": getattr(self._pipe, "fused_fallback_count",
                                       0),
            "healthy": self.healthy(),
        }
