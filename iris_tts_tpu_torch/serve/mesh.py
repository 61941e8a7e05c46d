"""Serving over a mesh of processes: rank 0 serves, the others follow.

Counterpart of the JAX package's ``scripts/serve.py --mesh``. There one
process drives every device and ``use_mesh`` is enough; here each device
has its own process (SPMD), and every rank must make the same pipeline
calls in the same order for the collectives inside them to meet. So world
rank 0 runs the ``DynamicBatcher`` and the HTTP server over a
:class:`MeshLeader`, which, before each device call the batcher makes
(``synthesize``, ``_batched_dispatch``, the warmups), sends the call to
every other rank: its kind, texts, seed, temperature, path, PCM16 and
buckets. Every other rank runs :func:`follow`, which makes the same
``TTSPipeline`` call, and returns on the stop message rank 0 sends when it
shuts down.

The messages cross on the host: a gloo group over the world (the world
group itself where it is gloo), a length agreed by an all-reduce (so rank
0 hears at once of a follower that is gone and fails the request instead
of dispatching into a collective no one answers) and a broadcast of the
pickled call. Only the batcher's device thread sends, so the HTTP threads
never wait on a follower. While the queue is empty the device thread sends
a heartbeat at least every :attr:`MeshLeader.heartbeat_s`, well inside the
collective timeout a follower waits in.
"""

from __future__ import annotations

import logging
import pickle
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from iris_tts_tpu_torch.parallel import mesh as mesh_mod
from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES, host_group

logger = logging.getLogger(__name__)

# The pipeline calls a follower makes; anything else is refused.
DEVICE_CALLS = ("synthesize", "_batched_dispatch", "warmup_fused",
                "warmup_batched")


class _Channel:
    """World rank 0 → every rank, on the host."""

    def __init__(self, mesh):
        self.group = host_group(mesh)

    def send(self, msg) -> None:
        data = pickle.dumps(msg)
        n = torch.tensor([len(data)], dtype=torch.int64)
        COLLECTIVES[("serve_control", "all_reduce", "gloo")] += 1
        dist.all_reduce(n, op=dist.ReduceOp.MAX, group=self.group)
        COLLECTIVES[("serve_control", "broadcast", "gloo")] += 1
        dist.broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                       src=0, group=self.group)

    def recv(self):
        n = torch.zeros(1, dtype=torch.int64)
        COLLECTIVES[("serve_control", "all_reduce", "gloo")] += 1
        dist.all_reduce(n, op=dist.ReduceOp.MAX, group=self.group)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        COLLECTIVES[("serve_control", "broadcast", "gloo")] += 1
        dist.broadcast(buf, src=0, group=self.group)
        return pickle.loads(buf.numpy().tobytes())


def _heartbeat_s() -> float:
    """A third of the collective timeout, at most 30 s."""
    timeout = mesh_mod._TIMEOUT
    return 30.0 if timeout is None else min(30.0,
                                            timeout.total_seconds() / 3)


class MeshLeader:
    """World rank 0's pipeline under ``serve --mesh``: a
    :class:`~iris_tts_tpu_torch.models.pipeline.TTSPipeline` on a mesh
    (``use_mesh``) whose device calls are sent to the followers first. Any
    other attribute is the pipeline's. ``calls`` counts the device calls;
    a follower's :func:`follow` returns its own count."""

    def __init__(self, pipe):
        if pipe._mesh is None or not mesh_mod.is_primary(pipe._mesh):
            raise ValueError("MeshLeader runs on world rank 0 of a "
                             "pipeline's mesh (TTSPipeline.use_mesh)")
        self._pipe = pipe
        self._channel = _Channel(pipe._mesh)
        self.heartbeat_s = _heartbeat_s()
        self.calls = 0
        self._last = time.monotonic()
        self._failed: Optional[BaseException] = None

    def __getattr__(self, name: str) -> Any:
        if name == "_pipe":  # not set yet
            raise AttributeError(name)
        return getattr(self._pipe, name)

    def _send(self, msg) -> None:
        if self._failed is not None:
            raise RuntimeError("a rank of the serving mesh is gone") \
                from self._failed
        try:
            self._channel.send(msg)
        except Exception as e:
            self._failed = e
            raise
        self._last = time.monotonic()

    def _call(self, kind: str, *args, **kwargs):
        self._send((kind, args, kwargs))
        self.calls += 1
        return getattr(self._pipe, kind)(*args, **kwargs)

    # the batcher's device calls; the seed is resolved here, so every rank
    # draws the same noise whatever its own seed counter
    def synthesize(self, text, seed=None, **kwargs):
        return self._call("synthesize", text,
                          seed=self._pipe._next_seed(seed), **kwargs)

    def _batched_dispatch(self, texts, seed=None, **kwargs):
        return self._call("_batched_dispatch", texts,
                          seed=self._pipe._next_seed(seed), **kwargs)

    def warmup_fused(self, *args, **kwargs):
        return self._call("warmup_fused", *args, **kwargs)

    def warmup_batched(self, *args, **kwargs):
        return self._call("warmup_batched", *args, **kwargs)

    def idle(self) -> None:
        """Called by the batcher's device thread while its queue is empty:
        a heartbeat once ``heartbeat_s`` has passed without a message."""
        if (self._failed is None
                and time.monotonic() - self._last >= self.heartbeat_s):
            try:
                self._send(("idle", (), {}))
            except Exception:  # noqa: BLE001 — the next request fails
                logger.exception("serving mesh heartbeat failed")

    def stop(self) -> None:
        """Tell every follower to return (after the batcher stopped)."""
        if self._failed is None:
            self._send(("stop", (), {}))


def follow(pipe) -> int:
    """A follower rank's loop: make each device call world rank 0 sends,
    until it sends stop (or this process is interrupted). A call that
    raises is logged and the loop goes on, as rank 0's batcher fails that
    request and goes on. Returns the number of device calls made."""
    channel = _Channel(pipe._mesh)
    calls = 0
    with torch.inference_mode():
        while True:
            try:
                kind, args, kwargs = channel.recv()
            except KeyboardInterrupt:
                return calls
            if kind == "stop":
                return calls
            if kind == "idle":
                continue
            if kind not in DEVICE_CALLS:
                raise ValueError(f"unknown serving call {kind!r}")
            calls += 1
            try:
                getattr(pipe, kind)(*args, **kwargs)
            except Exception:  # noqa: BLE001 — rank 0 fails the request
                logger.exception("follower %s failed", kind)
