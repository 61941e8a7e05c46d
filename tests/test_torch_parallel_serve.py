"""``python -m iris_tts_tpu_torch.serve --mesh`` on two gloo ranks on the
CPU: world rank 0 runs the batcher and the HTTP server, rank 1 follows its
device calls (``serve/mesh.py``). Its answers for fixed seeds against the
one-process server's, the follower's device calls against rank 0's, and
a follower that is gone failing the request instead of hanging it.

The ranks run the server's own ``main`` (``tests/torch_mesh_ranks.py``,
scenario ``serve``); rank 0 stops on SIGINT, as the command does.
"""

import dataclasses
import http.client
import io
import json
import re
import signal
import socket
import threading
import time
import wave

import numpy as np
import pytest
import torch

from iris_tts_tpu_torch import config as port_cfg
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.serve import TTSServer
from iris_tts_tpu_torch.serve.__main__ import main as serve_main
from tests import torch_mesh_ranks as R
from tests.torch_port_utils import small_config

torch.set_num_threads(2)

SEEDED = [("Hello world.", 3), ("The quick brown fox jumps over the lazy dog.",
                                 5), ("Speech!", 8)]
BURST = ["One.", "Two words.", "Three more words.", "And a fourth.",
         "Fifth.", "Sixth and last."]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _pcm(body) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _save_pipe(path, **ladders):
    pipe = TTSPipeline.initialize(small_config(port_cfg), seed=3,
                                  device="cpu")
    with torch.no_grad():  # audible PCM16 at this width
        for n, p in pipe.model.hifigan.named_parameters():
            if n.endswith("weight"):
                p.mul_(15.0)
    dataclasses.replace(pipe, **ladders).save(path)


def _launch(work, pipe_dir, **kw):
    port = _free_port()
    argv = ["--pipeline", str(pipe_dir), "--device", "cpu", "--mesh",
            "--host", "127.0.0.1", "--port", str(port), "--max_batch", "2",
            "--max_wait_ms", "20"]
    (work / "serve_args.json").write_text(json.dumps(argv))
    return R.start_ranks("serve", work, 2, **kw), port


def _wait_healthy(group, port, deadline_s=240.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        for r, p in enumerate(group.procs):
            if p.poll() is not None:
                raise RuntimeError(f"rank {r} exited with {p.returncode}:\n"
                                   + group._tail(r))
        try:
            if _request(port, "GET", "/healthz", timeout=5)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise TimeoutError("the mesh server did not come up:\n" + group._tail(0))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_serve")
    ladders = dict(phoneme_buckets=(16, 32, 64), frame_buckets=(32, 64, 128,
                                                                256, 512))
    _save_pipe(work / "pipe", **ladders)
    group, port = _launch(work, work / "pipe", deadline_s=420)
    try:
        ref = TTSPipeline.load(work / "pipe", device="cpu")
        server = TTSServer(ref, host="127.0.0.1", port=0, max_batch=2,
                           pcm16_transfer=True).start()
        try:
            want = [_request(server.address[1], "POST", "/synthesize",
                             {"text": t, "seed": s}) for t, s in SEEDED]
        finally:
            server.stop()
        _wait_healthy(group, port)
        got = [_request(port, "POST", "/synthesize", {"text": t, "seed": s})
               for t, s in SEEDED]
        burst = [None] * len(BURST)

        def post(i):
            burst[i] = _request(port, "POST", "/synthesize",
                                {"text": BURST[i]})

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(BURST))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = json.loads(_request(port, "GET", "/stats")[1])
        group.procs[0].send_signal(signal.SIGINT)
        results = group.join()
    finally:
        for p in group.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(work / f"rank{r}.log").read_text() for r in range(2)]
    return {"want": want, "got": got, "burst": burst, "stats": stats,
            "results": results, "logs": logs}


def test_seeded_answers_equal_the_one_process_server(served):
    """Three seeded requests (the fused path, one row padded to the two
    ranks of the data axis, so each rank runs the one-process shape): the
    WAV of each equals the one-process server's, and it is not silent.
    (The ranks and this process compute with two threads each: oneDNN's
    blocking follows the thread count.)"""
    for (ws, wb), (gs, gb) in zip(served["want"], served["got"]):
        assert ws == gs == 200
        want, got = _pcm(wb), _pcm(gb)
        assert want.size and np.abs(want).max() > 100
        np.testing.assert_array_equal(got, want)


def test_a_burst_of_unseeded_requests_is_answered(served):
    """Six concurrent requests (co-batched on the two-stage path,
    ``_batched_dispatch`` on every rank) all answer with audio."""
    for status, body in served["burst"]:
        assert status == 200 and _pcm(body).size
    assert served["stats"]["requests"] >= len(SEEDED) + len(BURST)


def _calls(log: str, role: str) -> int:
    m = re.search(rf"mesh {role}: (\d+) device calls", log)
    assert m, log[-2000:]
    return int(m.group(1))


def test_the_follower_made_rank_0s_device_calls(served):
    """Rank 1 made as many device calls as rank 0 (the two warmups and one
    a dispatch), and both returned when rank 0 stopped."""
    leader = _calls(served["logs"][0], "leader")
    follower = _calls(served["logs"][1], "follower")
    assert leader == follower >= 2 + len(SEEDED) + 1
    for rank in served["results"]:
        calls = rank["collectives"]
        paths = {path for (path, _, _) in calls}
        assert {"serve_control", "use_mesh", "replicate"} <= paths
        assert {op for (_, op, _) in calls} <= {"all_reduce", "broadcast"}


def test_a_follower_that_is_gone_fails_the_request(tmp_path):
    """With rank 1 killed, rank 0 answers the next request with an error
    (500) at once instead of hanging it in a collective."""
    _save_pipe(tmp_path / "pipe", phoneme_buckets=(16, 32),
               frame_buckets=(32, 64, 128))
    group, port = _launch(tmp_path, tmp_path / "pipe", deadline_s=300)
    try:
        _wait_healthy(group, port)
        group.procs[1].kill()
        group.procs[1].wait()
        t0 = time.monotonic()
        status, body = _request(port, "POST", "/synthesize",
                                {"text": "Hello world.", "seed": 1},
                                timeout=60)
        assert status == 500, body
        assert time.monotonic() - t0 < R.RANK_TIMEOUT_S
        status, _ = _request(port, "POST", "/synthesize",
                             {"text": "Again.", "seed": 2}, timeout=60)
        assert status == 500
    finally:
        for p in group.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in group.logs:
            f.close()


def test_mesh_with_aot_is_refused():
    with pytest.raises(SystemExit):
        serve_main(["--aot", "unused", "--mesh"])
