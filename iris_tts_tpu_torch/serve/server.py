"""Stdlib HTTP frontend over the dynamic batcher.

Endpoints:
    POST /synthesize        {"text": "...", "temperature": 1.0, "seed": 0}
                            → audio/wav bytes (22.05 kHz PCM16)
    POST /synthesize_stream same body → chunked-transfer raw PCM16LE:
                            sentence chunks stream as they synthesize, so
                            time-to-first-audio is one chunk's latency
    GET  /healthz           → {"ok": true} (503 if the device thread died)
    GET  /stats             → batcher counters + latency percentiles

ThreadingHTTPServer gives one thread per connection; all of them funnel
into the single-device-thread :class:`DynamicBatcher`, so concurrency maps
to batch size, not device contention. Handler threads run only the host
text frontend (sentence chunking); the batcher's thread alone touches the
card. Standard library only (no extra serving dependencies).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from iris_tts_tpu_torch.data.audio_io import wav_bytes
from iris_tts_tpu_torch.serve.batcher import (
    DynamicBatcher,
    ServerOverloadedError,
    ServerStoppedError,
)

logger = logging.getLogger(__name__)

_MAX_BODY = 1 << 20  # 1 MiB of JSON is far beyond any sane request


def _pcm16le(audio) -> bytes:
    audio = np.asarray(audio)
    if audio.dtype == np.int16:  # already device-quantized (pcm16 path)
        return audio.astype("<i2").tobytes()
    clipped = np.clip(audio.astype(np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype("<i2").tobytes()


class _Handler(BaseHTTPRequestHandler):
    server_version = "iris-tts-torch"
    # HTTP/1.1 is REQUIRED for Transfer-Encoding: chunked — under the
    # stdlib default (HTTP/1.0) clients would read the hex framing lines
    # as PCM samples. Every non-streaming response carries Content-Length,
    # satisfying 1.1 keep-alive.
    protocol_version = "HTTP/1.1"
    batcher: DynamicBatcher = None  # set by TTSServer
    sample_rate: int = 22050
    request_timeout_s: float = 600.0

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _read_json_body(self):
        """Parse the request body; returns a dict or None (response sent).

        Hostile framing is handled without trusting the client: a negative
        Content-Length would make ``rfile.read`` block until EOF (one
        leaked thread per request — remote DoS), an oversize/garbage body
        cannot be drained safely, so those error paths CLOSE the
        connection rather than attempt HTTP/1.1 keep-alive resync.
        """
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            n = -1
        if n < 0 or n > _MAX_BODY:
            # The body was not consumed; the next keep-alive request would
            # parse leftover bytes as a request line.
            self.close_connection = True
            if n < 0:
                self._json(400, {"error": "bad Content-Length"})
            else:
                self._json(413, {"error": "request too large"})
            return None
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            self._json(400, {"error": "invalid JSON"})
            return None
        if not isinstance(req, dict):
            # 'null' would read as None (indistinguishable from
            # response-already-sent) and a list/str would AttributeError
            # on req.get() deep in a handler.
            self._json(400, {"error": "body must be a JSON object"})
            return None
        return req

    def _overloaded(self, e: Exception) -> None:
        """503 + Retry-After: queue-depth backpressure (batcher.max_queue)."""
        body = json.dumps({"error": str(e)}).encode()
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", "1")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server contract
        if self.path == "/healthz":
            # Liveness includes the device thread: a dead batcher would
            # otherwise accept connections and hang every request.
            ok = self.batcher.healthy()
            self._json(200 if ok else 503, {"ok": ok})
        elif self.path == "/stats":
            self._json(200, self.batcher.stats())
        else:
            self._json(404, {"error": "unknown path"})

    def _stream_synthesize(self, req) -> None:
        """POST /synthesize_stream: chunked-transfer PCM16LE.

        Sentence chunks are submitted to the batcher as independent
        requests and streamed (with the silence gaps) as each resolves —
        time-to-first-audio is one chunk's latency instead of the whole
        text's, and concurrent streams still share batched dispatches.
        """
        t_start = time.monotonic()
        text = req.get("text", "")
        if not isinstance(text, str) or not text.strip():
            self._json(400, {"error": "missing 'text'"})
            return
        try:
            chunks = self.batcher.chunk_text(text)
            temperature = float(req.get("temperature", 1.0))
            seed = req.get("seed")
            # Per-chunk derived seeds: a seeded stream is reproducible in
            # (text, seed) and each chunk gets distinct noise. (The batch
            # endpoint synthesizes a long text's chunks as rows of ONE
            # dispatch, so the two endpoints are each deterministic but
            # not sample-identical to each other.)
            def chunk_seed(i):
                return None if seed is None else int(seed) + i

            # The FIRST chunk goes in alone so time-to-first-audio is one
            # small dispatch; the rest are submitted once it resolves and
            # batch together while the head of the stream plays out.
            first = self.batcher.submit(
                chunks[0], temperature=temperature, seed=chunk_seed(0),
                chunks=[chunks[0]],
            )
        except (TypeError, ValueError) as e:
            self._json(400, {"error": str(e)})
            return
        except ServerOverloadedError as e:  # backpressure → retryable 503
            self._overloaded(e)
            return
        except ServerStoppedError as e:  # draining replica → retryable
            self._json(503, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — server-side fault
            self._json(500, {"error": str(e)})
            return

        self.send_response(200)
        # audio/L16 would imply BIG-endian (RFC 3555); the body is
        # little-endian PCM, so advertise it honestly.
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("X-Audio-Format",
                         f"pcm16le; rate={self.sample_rate}; channels=1")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_chunk(data: bytes) -> None:
            if not data:
                return  # a zero-length chunk IS the stream terminator
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        gap = np.zeros(
            int(round(self.batcher._gap_ms / 1000.0 * self.sample_rate)),
            np.float32,
        )
        try:
            audio = first.result(timeout=self.request_timeout_s)
            write_chunk(_pcm16le(audio))
            # TTFA: first audio bytes on the wire, measured from request
            # arrival — the streaming latency metric (/stats "ttfa_ms").
            self.batcher.record_ttfa(time.monotonic() - t_start)
            # bypass_admission: this stream was admitted via its first
            # chunk; 503-ing its continuation chunks under load would
            # truncate a response whose 200 header is already on the wire.
            futs = [
                self.batcher.submit(c, temperature=temperature,
                                    seed=chunk_seed(i + 1), chunks=[c],
                                    bypass_admission=True)
                for i, c in enumerate(chunks[1:])
            ]
            for f in futs:
                audio = f.result(timeout=self.request_timeout_s)
                write_chunk(_pcm16le(gap))
                write_chunk(_pcm16le(audio))
            self.wfile.write(b"0\r\n\r\n")
        except Exception:  # noqa: BLE001 — mid-stream failure: cut the
            # connection (the truncated chunked body tells the client)
            logger.exception("stream aborted")
            self.close_connection = True

    def do_POST(self):  # noqa: N802
        req = self._read_json_body()
        if req is None:
            return
        if self.path == "/synthesize_stream":
            self._stream_synthesize(req)
            return
        if self.path != "/synthesize":
            self._json(404, {"error": "unknown path"})
            return
        try:
            text = req.get("text", "")
            if not isinstance(text, str) or not text.strip():
                self._json(400, {"error": "missing 'text'"})
                return
            audio = self.batcher.synthesize(
                text,
                timeout=self.request_timeout_s,
                temperature=float(req.get("temperature", 1.0)),
                seed=req.get("seed"),
            )
        except (TypeError, ValueError) as e:  # client fault
            self._json(400, {"error": str(e)})
            return
        except ServerOverloadedError as e:  # backpressure → retryable 503
            self._overloaded(e)
            return
        except ServerStoppedError as e:  # draining replica → retryable
            self._json(503, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — server fault
            logger.exception("synthesize failed")
            self._json(500, {"error": str(e)})
            return
        wav = wav_bytes(audio, self.sample_rate)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(wav)))
        self.end_headers()
        self.wfile.write(wav)


class TTSServer:
    """HTTP server + batcher lifecycle in one object.

    Usage:
        server = TTSServer(pipeline, port=8080).start()
        ...
        server.stop()
    """

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 8080,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 request_timeout_s: float = 600.0,
                 pcm16_transfer: bool = False,
                 max_queue: int = 256,
                 max_batch_limit: int | None = None):
        self.batcher = DynamicBatcher(
            pipeline, max_batch=max_batch, max_wait_ms=max_wait_ms,
            pcm16_transfer=pcm16_transfer, max_queue=max_queue,
            max_batch_limit=max_batch_limit,
        )
        handler = type("BoundHandler", (_Handler,), {
            "batcher": self.batcher,
            "sample_rate": pipeline.config.audio.sample_rate,
            # Generous default: a request queued behind a long text, or a
            # shape that was not warmed, can take far longer than the
            # warmed steady state.
            "request_timeout_s": request_timeout_s,
        })
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self.httpd.server_address

    def start(self) -> "TTSServer":
        """Start the batcher (which first runs every serving shape on its
        device thread), then accept connections."""
        self.batcher.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="tts-http", daemon=True
        )
        self._serve_thread.start()
        logger.info("serving on %s:%d", *self.httpd.server_address[:2])
        return self

    def stop(self) -> None:
        if self._serve_thread is not None:
            # shutdown() blocks on an event only serve_forever() ever
            # sets — calling it on a never-started server deadlocks the
            # caller's cleanup path.
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
            self._serve_thread = None
        self.batcher.stop()


def serve_forever(pipeline, host: str = "0.0.0.0", port: int = 8080,
                  max_batch: int = 8, max_wait_ms: float = 5.0,
                  request_timeout_s: float = 600.0,
                  pcm16_transfer: bool = False,
                  max_queue: int = 256,
                  max_batch_limit: int | None = None) -> None:
    """Blocking entry point for CLI use (``python -m
    iris_tts_tpu_torch.serve``): runs every serving shape once on the
    device thread, then serves until Ctrl-C stops it cleanly."""
    server = TTSServer(pipeline, host=host, port=port, max_batch=max_batch,
                       max_wait_ms=max_wait_ms,
                       request_timeout_s=request_timeout_s,
                       pcm16_transfer=pcm16_transfer,
                       max_queue=max_queue,
                       max_batch_limit=max_batch_limit)
    server.batcher.start()
    logger.info("warmup: %d shapes (batch buckets %s) on the device thread "
                "in %.1f s", server.batcher.n_warmed,
                server.batcher._batch_buckets, server.batcher.warmup_s)
    logger.info("serving on %s:%d", *server.httpd.server_address[:2])
    try:
        server.httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.httpd.server_close()
        server.batcher.stop()
