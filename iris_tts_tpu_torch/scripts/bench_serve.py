"""Serving under load: concurrent clients against the dynamic batcher.

The port's counterpart of the JAX package's ``scripts/bench_serve.py``.
Drives the serving stack, either the ``DynamicBatcher`` in-process or the
HTTP server over localhost (``--http``), and prints one JSON line a run:
achieved QPS, client-side latency percentiles (p50/p95/p99/max), the
realtime factor of the audio served, the mean device batch, the batch-size
histogram of the run and the admission rejections.

Two load models:

* closed loop (default): N client threads, each sending a request, waiting
  for its waveform and sending the next: capacity and latency at full
  concurrency;
* open loop (``--offered_qps R``, in-process only): Poisson arrivals at a
  fixed offered rate, whatever the completions: queueing delay and 503s
  as the offered load nears capacity.

The texts cycle deterministically through mixed lengths, so several
phoneme buckets and the chunking path run. Each batcher warms every
serving shape on its device thread when it starts (cuDNN keeps its
execution plans per thread), and ``warmup()`` runs them once more before
the load, as the JAX script calls it.

Usage:
    python -m iris_tts_tpu_torch.scripts.bench_serve --clients 16 \
        --requests 8 [--device cpu]
    python -m iris_tts_tpu_torch.scripts.bench_serve --offered_qps 40 \
        --requests 200
    python -m iris_tts_tpu_torch.scripts.bench_serve --http --clients 8 \
        --requests 4
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import sys
import threading
import time
import wave

import numpy as np

from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.serve import DynamicBatcher, TTSServer
from iris_tts_tpu_torch.serve.batcher import ServerOverloadedError
from iris_tts_tpu_torch.scripts.common import (
    add_device_arg,
    device_label,
    resolve_config,
    setup_logging,
)

# Mixed lengths on purpose: short fits the smallest phoneme bucket, the
# long one spans buckets, and the number-heavy one runs normalization.
TEXTS = [
    "Hello there.",
    "The quick brown fox jumps over the lazy dog.",
    "In a quiet village by the sea, an old clockmaker wound his machines "
    "every morning before dawn, listening for the first gulls.",
    "Testing one two three.",
    "Numbers like 42 and dates like March 3rd get normalized by the "
    "frontend before synthesis.",
]
OPEN_LOOP_SEED = 20260818


def _pct(sorted_seq, p):
    if not sorted_seq:
        return None
    return round(
        1000 * sorted_seq[min(len(sorted_seq) - 1, int(p * len(sorted_seq)))],
        2,
    )


def _audio_seconds_inproc(audio: np.ndarray, sr: int) -> float:
    return float(audio.shape[0]) / sr


def _http_synthesize(host: str, port: int, text: str, timeout: float):
    """POST /synthesize; returns the WAV body's sample count."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps({"text": text}).encode()
        conn.request("POST", "/synthesize", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status == 503:
            raise ServerOverloadedError("503")
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        with wave.open(io.BytesIO(data)) as w:
            return w.getnframes()
    finally:
        conn.close()


def closed_loop(submit, n_clients, n_requests, timeout):
    """Each client thread: send → wait → send. Returns (latencies, audio
    seconds, rejections, wall seconds)."""
    lats, audio_s, rejected, errors = [], [0.0], [0], [0]
    lock = threading.Lock()

    def client(ci):
        for ri in range(n_requests):
            text = TEXTS[(ci * 7 + ri) % len(TEXTS)]
            t0 = time.perf_counter()
            try:
                secs = submit(text, timeout)
            except ServerOverloadedError:
                with lock:
                    rejected[0] += 1
                continue
            except Exception as e:  # noqa: BLE001 — keep the client going
                with lock:
                    errors[0] += 1
                print(f"client {ci} request {ri}: {e!r}", file=sys.stderr)
                continue
            dt = time.perf_counter() - t0
            with lock:
                lats.append(dt)
                audio_s[0] += secs

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return lats, audio_s[0], rejected[0], wall


def open_loop(batcher, sr, offered_qps, n_total, timeout):
    """Poisson arrivals at a fixed rate; latency includes queueing delay.

    Submits do not block (futures resolve later), so arrivals never wait
    on completions, the defining property of an open-loop test. Latency is
    stamped by a done-callback when each future resolves."""
    rng = np.random.default_rng(OPEN_LOOP_SEED)
    gaps = rng.exponential(1.0 / offered_qps, size=n_total)
    pending = []  # (t_submit, future)
    done_at = {}
    rejected = 0
    t0 = time.perf_counter()
    next_t = t0
    for i in range(n_total):
        next_t += gaps[i]
        now = time.perf_counter()
        if next_t > now:
            time.sleep(next_t - now)
        text = TEXTS[i % len(TEXTS)]
        t_sub = time.perf_counter()
        try:
            fut = batcher.submit(text)
        except ServerOverloadedError:
            rejected += 1
            continue
        fut.add_done_callback(
            lambda f, key=id(fut): done_at.setdefault(
                key, time.perf_counter())
        )
        pending.append((t_sub, fut))
    lats, audio_s = [], 0.0
    for t_sub, fut in pending:
        audio = fut.result(timeout=timeout)
        lats.append(done_at[id(fut)] - t_sub)
        audio_s += float(audio.shape[0]) / sr
    wall = time.perf_counter() - t0
    return lats, audio_s, rejected, wall


def _rates(text):
    """``--offered_qps``: validated when parsed, so a typo'd rate fails
    before minutes of model set-up and warmup; a rate must be > 0 (1/rate
    is the Poisson mean gap)."""
    try:
        rates = [float(x) for x in text.split(",")]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"not a comma list of numbers: {text!r}")
    if any(r <= 0 for r in rates):
        raise argparse.ArgumentTypeError(
            f"rates must be > 0 req/s: {text!r}")
    return rates


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", type=str, default=None,
                    help="IrisConfig JSON (default: production config)")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client (closed loop) or total "
                    "requests (open loop)")
    ap.add_argument("--offered_qps", type=_rates, default=None,
                    help="open-loop Poisson arrival rate in req/s, > 0 "
                    "(in-process only); a comma list sweeps rates in one "
                    "process so the warmup is paid once")
    ap.add_argument("--http", action="store_true",
                    help="drive the real HTTP server over localhost")
    ap.add_argument("--pcm16", action="store_true",
                    help="device-side PCM16 transfer (halves the bytes "
                    "copied to the host)")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_batch_limit", type=int, default=None,
                    help="adaptive batch growth ceiling (default: no "
                    "growth)")
    ap.add_argument("--ab_max_batch_limit", type=int, default=None,
                    help="A/B mode: run the fixed-batch baseline AND an "
                    "adaptive batcher with this growth ceiling in one "
                    "process (one JSON line per config per rate); "
                    "in-process only")
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--max_queue", type=int, default=256)
    ap.add_argument("--timeout_s", type=float, default=600.0)
    ap.add_argument("--phoneme_buckets", type=str, default=None,
                    help="comma list override (small values for CPU smoke)")
    ap.add_argument("--frame_buckets", type=str, default=None)
    add_device_arg(ap)
    return ap


def main(argv=None) -> list:
    """Prints one JSON line a run and returns the payloads."""
    ap = build_parser()
    args = ap.parse_args(argv)
    setup_logging()

    # Flag conflicts before model set-up, as the rate validator.
    if args.offered_qps and args.http:
        ap.error("--offered_qps is in-process only (no --http)")
    if args.ab_max_batch_limit is not None and args.http:
        ap.error("--ab_max_batch_limit is in-process only (no --http)")
    if args.ab_max_batch_limit is not None and args.max_batch_limit is not None:
        # Forcing the fixed baseline to limit=None would discard the
        # user's --max_batch_limit; make the conflict explicit.
        ap.error("--ab_max_batch_limit runs its own fixed(None) baseline; "
                 "drop --max_batch_limit")

    device = resolve_device(args.device)
    print(f"device: {device_label(device)}", file=sys.stderr)
    pipe = TTSPipeline.initialize(resolve_config(args), seed=0,
                                  device=device)
    if args.phoneme_buckets:
        pipe.phoneme_buckets = tuple(
            int(x) for x in args.phoneme_buckets.split(","))
    if args.frame_buckets:
        pipe.frame_buckets = tuple(
            int(x) for x in args.frame_buckets.split(","))
    sr = pipe.config.audio.sample_rate

    offered_rates = args.offered_qps or []
    mode = "open" if offered_rates else "closed"
    transport = "http" if args.http else "inproc"

    # --ab_max_batch_limit N runs the fixed-batch baseline and the adaptive
    # config back to back on one pipeline.
    if args.ab_max_batch_limit is not None:
        configs = [("fixed", None), ("adaptive", args.ab_max_batch_limit)]
    else:
        configs = [(None, args.max_batch_limit)]

    runs = []  # (label, limit, rate|None, lats, audio_s, rej, wall, n, hist)
    for label, limit in configs:
        t0 = time.perf_counter()
        if args.http:
            server = TTSServer(
                pipe, host="127.0.0.1", port=0, max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
                pcm16_transfer=args.pcm16,
                request_timeout_s=args.timeout_s,
                max_batch_limit=limit,
            ).start()
            host, port = server.address[:2]
            batcher = server.batcher
        else:
            batcher = DynamicBatcher(
                pipe, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                max_queue=args.max_queue, pcm16_transfer=args.pcm16,
                max_batch_limit=limit,
            ).start()
            server = None

        try:
            print(f"[{label or 'default'}] start: {batcher.n_warmed} "
                  f"serving shapes warmed on the device thread in "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
            t0 = time.perf_counter()
            n_shapes = batcher.warmup()
            print(f"warmup done in {time.perf_counter() - t0:.1f}s "
                  f"({n_shapes} shapes)", file=sys.stderr)

            if args.http:
                def submit(text, timeout, h=host, p=port):
                    return _http_synthesize(h, p, text, timeout) / sr
            else:
                def submit(text, timeout, b=batcher):
                    audio = b.synthesize(text, timeout=timeout)
                    return _audio_seconds_inproc(audio, sr)

            prev_hist = dict(batcher.stats()["batch_size_hist"])

            def _hist_delta(b=batcher):
                # The batcher's counters are cumulative: per-run numbers.
                nonlocal prev_hist
                cur = dict(b.stats()["batch_size_hist"])
                delta = {k: v - prev_hist.get(k, 0) for k, v in cur.items()
                         if v - prev_hist.get(k, 0) > 0}
                prev_hist = cur
                return delta

            if mode == "open":
                for rate in offered_rates:
                    lats, audio_s, rejected, wall = open_loop(
                        batcher, sr, rate, args.requests, args.timeout_s,
                    )
                    runs.append((label, limit, rate, lats, audio_s, rejected,
                                 wall, args.requests, _hist_delta()))
            else:
                lats, audio_s, rejected, wall = closed_loop(
                    submit, args.clients, args.requests, args.timeout_s,
                )
                runs.append((label, limit, None, lats, audio_s, rejected,
                             wall, args.clients * args.requests,
                             _hist_delta()))
        finally:
            (server.stop() if server else batcher.stop())

    payloads = []
    for label, limit, rate, lats, audio_s, rejected, wall, n_sent, hist \
            in runs:
        lats_sorted = sorted(lats)
        completed = len(lats)
        payload = {
            "metric": "serve_qps",
            "value": round(completed / wall, 2) if wall else 0.0,
            "unit": "req/s",
            "mode": mode,
            "transport": transport,
            "batcher": label,
            "max_batch_limit": limit,
            "clients": args.clients if mode == "closed" else None,
            "offered_qps": rate,
            "requests_sent": n_sent,
            "requests_completed": completed,
            "rejected_503": rejected,
            "latency_ms": {
                "p50": _pct(lats_sorted, 0.50),
                "p95": _pct(lats_sorted, 0.95),
                "p99": _pct(lats_sorted, 0.99),
                "max": _pct(lats_sorted, 1.0),
            },
            "audio_rt_factor": round(audio_s / wall, 2) if wall else 0.0,
            "mean_batch_size": (
                round(sum(int(k) * v for k, v in hist.items())
                      / max(sum(hist.values()), 1), 2)
            ),
            "batch_size_hist": hist,
            "pcm16": bool(args.pcm16),
            "wall_s": round(wall, 2),
        }
        print(json.dumps(payload), flush=True)
        payloads.append(payload)
    return payloads


if __name__ == "__main__":
    main()
