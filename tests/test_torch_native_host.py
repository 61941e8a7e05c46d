"""The port's C++ serving host (``serve/csrc/aoti_runner.cpp``) on the CPU.

The counterpart of ``tests/test_pjrt_runner.py`` (and the npy fuzz of
``tests/test_properties.py``): every case of the JAX host's tests, against
one host built from the port's sources and one artifact exported with
``native=True`` (batch 1 × phoneme buckets 16 and 32) at a small width.
Where the JAX host's execution is gated to a TPU, this host runs here: its
audio and mel for ``synth`` and ``ids`` requests are held to
``ExportedSynthesizer``'s on the same artifact (within 1e-5 of the peak at
temperature 0 and 1, so the ATen generator's noise is Python's), ids,
n_frames and deficit exactly, and at temperature 0 to the JAX package's
``AotPipeline`` with the same weights.

The only skip is a machine with no C++ compiler; a failed build of the
port's source is a failure.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import threading
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.serve import export as texport
from iris_tts_tpu_torch.serve import native
from iris_tts_tpu_torch.serve.export import (
    ExportedSynthesizer,
    export_pipeline,
)
from iris_tts_tpu_torch.text.frontend import create_text_processor
from tests.test_torch_pipeline import _assert_clear_of_half, _assert_same_audio
from tests.torch_port_utils import numpy_tree, port_config, small_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
LEXICON = REPO / "iris_tts_tpu_torch" / "text" / "data" / "cmu_dict.txt"
LADDERS = dict(phoneme_buckets=(16, 32), frame_buckets=(32, 64, 128, 256, 512))
# The host's audio and mel against ExportedSynthesizer's, of the peak.
LIMIT = 1e-5
# The child's OpenMP pool: this process and the other test workers share
# the cores.
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline.initialize(small_config(), seed=3)
    # Random HiFiGAN weights give near-silent audio at this width; scale the
    # kernels so the comparisons see order-one signal.
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **LADDERS)
    pipe = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    return jpipe, dataclasses.replace(pipe, **LADDERS)


@pytest.fixture(scope="module")
def built(pipes, tmp_path_factory):
    """(host binary, artifact directory): g++ builds the host while
    AOTInductor compiles the two buckets, its cache in a temporary
    directory."""
    if not (os.environ.get("CXX") or shutil.which("g++")):
        pytest.skip("no C++ compiler")
    out = tmp_path_factory.mktemp("native")
    result = {}

    def build():
        try:
            result["host"] = native.build_host()
        except Exception as e:  # noqa: BLE001 — raised below
            result["error"] = e

    build_thread = threading.Thread(target=build)
    build_thread.start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TORCHINDUCTOR_CACHE_DIR", str(out / "inductor"))
        export_pipeline(pipes[1], out / "artifact", batch_sizes=(1,),
                        phoneme_buckets=(16, 32), vocode_chunk_frames=16,
                        native=True)
    build_thread.join()
    if "error" in result:
        raise result["error"]
    return result["host"], out / "artifact"


@pytest.fixture(scope="module")
def host(built):
    return built[0]


@pytest.fixture(scope="module")
def artifact(built):
    return built[1]


@pytest.fixture(scope="module")
def reference(artifact):
    return ExportedSynthesizer(
        artifact, text_processor=create_text_processor(use_g2p=False),
        device="cpu")


def _run(host, *args, stdin=None, timeout=300):
    return subprocess.run([str(host), *map(str, args)], input=stdin,
                          capture_output=True, text=True, timeout=timeout,
                          env=CHILD_ENV)


def _drive(host, artifact, requests, extra=("--dry-run",)):
    """Run the artifact host over a fixed request list → (ready, replies)."""
    r = _run(host, "--artifact", artifact, "--lexicon", LEXICON, *extra,
             stdin="".join(q + "\n" for q in requests))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    return lines[0], lines[1:]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert peak > 0.05, peak  # a real signal is compared
    return float(np.abs(got - want).max()) / peak


# -- .npy IO, probe, flags (tests/test_pjrt_runner.py) ---------------------------


@pytest.mark.parametrize(
    "arr",
    [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.array(7, dtype=np.int32),
        np.arange(5, dtype=np.int16),
        np.arange(8, dtype=np.int64).reshape(2, 2, 2),
        (np.random.default_rng(0).standard_normal(640) * 100).astype(
            np.float32
        ).reshape(1, 640),
    ],
    ids=["f32_2d", "i32_scalar", "i16_1d", "i64_3d", "f32_audio_row"],
)
def test_npy_roundtrip(host, tmp_path, arr):
    """The C++ npy reader/writer agrees with numpy bit for bit (dtype,
    shape incl. rank 0/1/3, payload)."""
    src, dst = tmp_path / "in.npy", tmp_path / "out.npy"
    np.save(src, arr)
    r = _run(host, "--npy-roundtrip", src, dst, timeout=60)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["bytes"] == arr.nbytes
    back = np.load(dst)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)


def test_probe(host):
    """libtorch's version and what it sees of CUDA, one JSON line (there is
    no plugin to probe)."""
    r = _run(host, "--probe", timeout=60)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out["libtorch"] == torch.__version__
    assert out["cuda_available"] is torch.cuda.is_available()
    assert out["device_count"] == len(out["devices"]) == (
        torch.cuda.device_count())


def test_bad_flags(host):
    r = _run(host, "--arg", "x", "--device", "cpu", timeout=60)
    assert r.returncode != 0 and "--package is required" in r.stderr
    r = _run(host, "--module", "x", timeout=60)
    assert r.returncode != 0 and "unknown flag --module" in r.stderr
    r = _run(host, "--package", "x", "--device", "tpu", timeout=60)
    assert r.returncode != 0 and "--device wants" in r.stderr


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_native_npy_reader_rejects_hostile_bytes(host, tmp_path_factory,
                                                 data):
    """Truncations/mutations of a valid .npy give a clean nonzero exit
    from the host's reader — never a crash signal or a hang."""
    tmp = tmp_path_factory.mktemp("fuzz")
    base = tmp / "base.npy"
    np.save(base, np.arange(24, dtype=np.float32).reshape(4, 6))
    raw = bytearray(base.read_bytes())
    mode = data.draw(st.sampled_from(["truncate", "mutate", "garbage"]))
    if mode == "truncate":
        raw = raw[: data.draw(st.integers(0, len(raw) - 1))]
    elif mode == "mutate":
        i = data.draw(st.integers(0, min(60, len(raw) - 1)))
        raw[i] = data.draw(st.integers(0, 255))
    else:
        raw = bytes(data.draw(
            st.lists(st.integers(0, 255), max_size=80).map(bytearray)))
    bad = tmp / "bad.npy"
    bad.write_bytes(bytes(raw))
    # binary capture: hostile header bytes echo into the diagnostic
    r = subprocess.run(
        [str(host), "--npy-roundtrip", str(bad), str(tmp / "out.npy")],
        capture_output=True, timeout=60, env=CHILD_ENV)
    assert r.returncode in (0, 1), (
        r.returncode, r.stderr.decode("utf-8", "replace"))


def test_binary_links_no_python(host):
    """The host is libtorch and the C++ runtime: no libpython among the
    ELF's NEEDED entries."""
    r = subprocess.run(["readelf", "-d", str(host)], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    needed = [ln for ln in r.stdout.splitlines() if "(NEEDED)" in ln]
    assert any("libtorch" in ln for ln in needed), needed
    assert not any("python" in ln.lower() for ln in needed), needed


# -- export --native ---------------------------------------------------------------


def test_manifest_records_the_packages(artifact):
    """One package beside each synthesis program, named in its entry with
    the torch that compiled it; the vocoder window gets none."""
    manifest = json.loads((artifact / "manifest.json").read_text())
    assert manifest["native_torch"] == torch.__version__
    assert manifest["format_version"] == texport.AOT_FORMAT_VERSION
    for e in manifest["entries"]:
        assert e["native_file"] == e["file"].replace(".pt2", ".aoti.pt2")
        assert (artifact / e["native_file"]).stat().st_size == \
            e["native_bytes"] > 1000
        assert e["native_compile_s"] > 0
    assert "native_file" not in manifest["vocode_window"]
    assert sorted(p.name for p in artifact.glob("*.aoti.pt2")) == [
        "synth_b1_p16.aoti.pt2", "synth_b1_p32.aoti.pt2"]


def test_export_cli_takes_native(monkeypatch, tmp_path):
    """``python -m iris_tts_tpu_torch.serve.export --native`` asks
    ``export_pipeline`` for the packages (the compile itself is the
    module fixture's)."""
    from iris_tts_tpu_torch import config as port_cfg

    seen = {}
    monkeypatch.setattr(texport, "export_pipeline",
                        lambda *a, **kw: seen.update(kw) or tmp_path)
    port_cfg.save_config(small_config(port_cfg), tmp_path / "cfg.json")
    texport.main(["--random_weights", "--config", str(tmp_path / "cfg.json"),
                  "--output", str(tmp_path / "aot"), "--device", "cpu",
                  "--native"])
    assert seen["native"] is True


# -- one-shot and --serve over one package ----------------------------------------


def _bucket_inputs(tmp_path, artifact, ids, seed=4):
    manifest = json.loads((artifact / "manifest.json").read_text())
    entry = manifest["entries"][0]
    b, p, t = entry["batch"], entry["phoneme_bucket"], entry["frame_bucket"]
    arr_ids = np.zeros((b, p), np.int64)
    arr_ids[0, :len(ids)] = ids
    eps = np.random.default_rng(seed).standard_normal(
        (b, manifest["latent_dim"], t // manifest["down_factor"])).astype(
            np.float32)
    arrays = {"ids": arr_ids, "lengths": np.array([len(ids)], np.int64),
              "eps": eps}
    for k, v in arrays.items():
        np.save(tmp_path / f"{k}.npy", v)
    return entry, arrays


def test_execute_package_one_shot(host, artifact, tmp_path):
    """``--package`` with ``--arg`` inputs (npy files and a scalar) runs the
    compiled bucket ``--iters`` times and writes its four outputs, equal to
    the ``torch.export`` program on the same inputs."""
    entry, arrays = _bucket_inputs(tmp_path, artifact, [4, 9, 12, 9, 4])
    r = _run(host, "--package", artifact / entry["native_file"],
             "--arg", tmp_path / "ids.npy", "--arg", tmp_path / "lengths.npy",
             "--arg", tmp_path / "eps.npy", "--arg", "f32:1.0",
             "--iters", "2", "--out-prefix", tmp_path / "out",
             "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout)
    assert stats["num_outputs"] == 4 and stats["iters"] == 2
    prog = torch.export.load(artifact / entry["file"]).module()
    want = prog(*(torch.from_numpy(arrays[k]) for k in ("ids", "lengths",
                                                         "eps")),
                torch.tensor(1.0))
    assert _rel(np.load(tmp_path / "out_0.npy"), want[0].numpy()) <= LIMIT
    assert _rel(np.load(tmp_path / "out_1.npy"), want[1].numpy()) <= LIMIT
    for i in (2, 3):
        np.testing.assert_array_equal(np.load(tmp_path / f"out_{i}.npy"),
                                      want[i].numpy())


def test_package_serve_mode_survives_bad_requests(host, artifact, tmp_path):
    """``--serve``: one reply per request line, a bad request (a missing
    .npy, too few fields) an error reply, and the server keeps serving."""
    entry, _ = _bucket_inputs(tmp_path, artifact, [4, 9, 12])
    args = " ".join(str(tmp_path / f"{k}.npy") for k in ("ids", "lengths",
                                                         "eps"))
    r = _run(host, "--package", artifact / entry["native_file"], "--serve",
             "--device", "cpu",
             stdin=f"{args} f32:0.5 {tmp_path / 'a'}\n"
                   f"{tmp_path / 'missing.npy'} {tmp_path / 'b'}\n"
                   "lonely\n"
                   f"{args} f32:0.5 {tmp_path / 'c'}\n")
    assert r.returncode == 0, r.stderr[-2000:]
    replies = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert len(replies) == 4
    assert "error" in replies[1] and "cannot open" in replies[1]["error"]
    assert "error" in replies[2]
    assert replies[0]["output_shapes"] == replies[3]["output_shapes"]
    np.testing.assert_array_equal(np.load(tmp_path / "a_0.npy"),
                                  np.load(tmp_path / "c_0.npy"))


# -- the artifact host: the request loop (tests/test_pjrt_runner.py) ---------------


def test_artifact_host_request_loop_dry_run(host, artifact, tmp_path):
    ready, replies = _drive(
        host, artifact,
        [f"synth\t{tmp_path}/a\t0\t1.0\thello world",
         f"ids\t{tmp_path}/b\t3\t0.8\t4,9,12,9",
         # a longer sentence must land in the bigger bucket
         f"synth\t{tmp_path}/c\t0\t1.0\t"
         "the quick brown fox jumps over the dog",
         # hostile: empty text → single <UNK>, server stays up
         f"synth\t{tmp_path}/d\t0\t1.0\t",
         "badverb\tx\t0\t1\ty",
         "toofewfields",
         f"ids\t{tmp_path}/e\t0\t1.0\tnot,numbers"])
    assert ready["ready"] is True
    assert ready["buckets"] == [[1, 16], [1, 32]]
    assert ready["lexicon_words"] > 100000
    assert ready["vocab"] == 41
    assert replies[0]["bucket"] == [1, 16] and replies[0]["n_ids"] == 8
    assert replies[1]["ids"] == [4, 9, 12, 9]
    assert replies[2]["bucket"] == [1, 32]
    assert replies[3]["n_ids"] == 1  # <UNK>
    assert "error" in replies[4]
    assert "error" in replies[5]
    assert "error" in replies[6]
    # one reply per request, server never died
    assert len(replies) == 7


def test_artifact_host_tokenizer_matches_python_frontends(host, artifact,
                                                          tmp_path):
    """The C++ lexicon tokenizer agrees with the port's Python frontend and
    the JAX package's on lexicon words (the ids feed the same programs the
    Python server runs: a divergence is different speech)."""
    from iris_tts_tpu.text import PhonemeVocab as JVocab
    from iris_tts_tpu.text import create_text_processor as jax_processor
    from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

    text = "the quick brown fox jumped over a lazy dog"
    port_ids = create_text_processor(use_g2p=False).text_to_ids(
        text, PhonemeVocab.load(artifact / "vocab.json")).tolist()
    jax_ids = jax_processor(use_g2p=False).text_to_ids(
        text, JVocab.load(artifact / "vocab.json")).tolist()
    _, replies = _drive(host, artifact,
                        [f"synth\t{tmp_path}/x\t0\t1.0\t{text}"])
    assert replies[0]["ids"] == port_ids == jax_ids


def test_artifact_host_rejects_bad_artifacts(host, artifact, tmp_path):
    # missing manifest
    r = _run(host, "--artifact", tmp_path, "--dry-run", timeout=60)
    assert r.returncode != 0 and "cannot open" in r.stderr
    # wrong format_version must refuse with a re-export message
    manifest = json.loads((artifact / "manifest.json").read_text())
    (tmp_path / "manifest.json").write_text(json.dumps(
        {**manifest, "format_version": texport.AOT_FORMAT_VERSION + 1}))
    r = _run(host, "--artifact", tmp_path, "--dry-run", timeout=60)
    assert r.returncode != 0 and "re-export" in r.stderr
    # an artifact exported without --native
    plain = dict(manifest, entries=[
        {k: v for k, v in e.items() if not k.startswith("native")}
        for e in manifest["entries"]])
    (tmp_path / "manifest.json").write_text(json.dumps(plain))
    r = _run(host, "--artifact", tmp_path, "--dry-run", timeout=60)
    assert r.returncode != 0 and "--native" in r.stderr


def test_artifact_host_oversized_request_is_an_error_not_a_crash(
        host, artifact, tmp_path):
    long_text = " ".join(["hello"] * 40)  # 160 ids > largest bucket (32)
    _, replies = _drive(host, artifact,
                        [f"synth\t{tmp_path}/z\t0\t1.0\t{long_text}",
                         f"synth\t{tmp_path}/ok\t0\t1.0\thi"])
    assert "error" in replies[0] and "bucket" in replies[0]["error"]
    assert replies[1]["n_ids"] >= 1  # server survived


# -- the artifact host executing on the CPU ----------------------------------------

# (verb, name, seed, temperature, payload): text and pre-tokenized ids, at
# temperature 0 and 1, routed to both buckets; a negative and an over-int32
# seed take the port's wrap.
SERVED = [
    ("synth", "s1", 5, 1.0, "hello world"),
    ("synth", "s0", 5, 0.0, "hello world"),
    ("synth", "long", -7, 1.0, "the quick brown fox jumps over the dog"),
    ("ids", "i1", 2**32 + 3, 1.0, "4,9,12,9"),
    ("ids", "i0", 3, 0.0, "4,9,12,9,20,31"),
]


@pytest.fixture(scope="module")
def served(host, artifact, tmp_path_factory):
    out = tmp_path_factory.mktemp("served")
    ready, replies = _drive(
        host, artifact,
        [f"{v}\t{out / n}\t{s}\t{t}\t{p}" for v, n, s, t, p in SERVED],
        extra=("--device", "cpu", "--npy"))
    return ready, replies, out


def test_artifact_host_serves_text_on_the_cpu(served, reference):
    """The host's WAV and ``--npy`` audio and mel for ``synth`` and ``ids``
    requests equal ``ExportedSynthesizer``'s on the same artifact within
    1e-5 of the peak, at temperature 0 and 1 (the ATen generator draws
    Python's noise); ids, n_frames and deficit exactly; routing 16 → 32."""
    ready, replies, out = served
    assert ready["ready"] and ready["device"] == "cpu"
    assert len(replies) == len(SERVED)
    tp = reference.text_processor
    for (verb, name, seed, temp, payload), rep in zip(SERVED, replies):
        assert "error" not in rep, rep
        ids = ([int(i) for i in payload.split(",")] if verb == "ids"
               else tp.text_to_ids(payload, reference.vocab).tolist())
        assert rep["ids"] == ids and rep["n_ids"] == len(ids)
        audio, mel, n, deficit = reference._synthesize_ids(
            np.asarray(ids), seed, temp)
        assert (rep["n_frames"], rep["deficit"]) == (n, deficit)
        got = np.load(out / f"{name}_audio.npy")
        assert got.dtype == np.float32
        assert _rel(got, audio) <= LIMIT, name
        assert _rel(np.load(out / f"{name}_mel.npy")[0], mel) <= LIMIT
        with wave.open(str(out / f"{name}.wav")) as w:
            assert w.getframerate() == 22050
            assert w.getnframes() == n * 256 == len(audio)
            pcm = np.frombuffer(w.readframes(n * 256), np.int16)
        assert np.abs(pcm.astype(np.int64)
                      - np.clip(np.round(got * 32767), -32768, 32767)
                      ).max() <= 1
        for k in ("upload_ms", "run_ms", "fetch_ms", "total_ms"):
            assert rep[k] >= 0
    assert replies[0]["bucket"] == [1, 16]
    assert replies[2]["bucket"] == [1, 32]


def test_temperature_and_seed_reach_the_noise(served):
    """Temperature 0 and 1 differ, so the temperature-1 match above holds
    the host's noise draw to Python's."""
    _, _, out = served
    hot, cold = np.load(out / "s1_audio.npy"), np.load(out / "s0_audio.npy")
    assert hot.shape == cold.shape and not np.allclose(hot, cold)


def test_host_matches_jax_aot_pipeline_at_temperature_0(pipes, served,
                                                        tmp_path):
    """The JAX package's AotPipeline, exported from the same weights, and
    the C++ host agree at temperature 0 within the port's synthesis
    contract."""
    from iris_tts_tpu.serve.export import AotPipeline as JAotPipeline
    from iris_tts_tpu.serve.export import export_pipeline as jexport

    jpipe, _ = pipes
    text = "hello world"
    _assert_clear_of_half(jpipe, [text])
    jexport(jpipe, tmp_path / "jax_aot", batch_sizes=(1,),
            phoneme_buckets=(16,))
    jaot = JAotPipeline(tmp_path / "jax_aot",
                        text_processor=jpipe.text_processor)
    _, _, out = served
    _assert_same_audio(np.load(out / "s0_audio.npy"),
                       jaot.synthesize(text, temperature=0.0))


# -- no fallback hides the device ----------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has CUDA")
def test_cuda_without_cuda_exits_nonzero(host, artifact):
    """``--device cuda`` (the default) on a machine without CUDA exits
    non-zero, in artifact and one-shot mode, and never runs on the CPU."""
    for flags in ([], ["--device", "cuda"], ["--device", "cuda:1"]):
        r = _run(host, "--artifact", artifact, "--lexicon", LEXICON, *flags,
                 stdin="synth\tx\t0\t1\thi\n", timeout=60)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert r.stdout == ""
    r = _run(host, "--package", artifact / "synth_b1_p16.aoti.pt2",
             timeout=60)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def _copy_artifact(artifact, dest, **manifest_kw):
    dest.mkdir()
    for f in artifact.iterdir():
        if f.is_file():
            os.symlink(f, dest / f.name)
    (dest / "manifest.json").unlink()
    manifest = json.loads((artifact / "manifest.json").read_text())
    manifest.update(manifest_kw)
    (dest / "manifest.json").write_text(json.dumps(manifest))
    return dest


def test_device_mismatch_and_torch_version_are_refused(host, artifact,
                                                       tmp_path):
    """Programs exported for one device type are refused on another, and
    packages compiled by another torch are refused before any load."""
    cuda_art = _copy_artifact(artifact, tmp_path / "cuda", device="cuda")
    r = _run(host, "--artifact", cuda_art, "--device", "cpu", timeout=60)
    assert r.returncode != 0 and "exported for cuda" in r.stderr
    old = _copy_artifact(artifact, tmp_path / "old", native_torch="0.0.1")
    r = _run(host, "--artifact", old, "--device", "cpu", timeout=60)
    assert r.returncode != 0 and "compiled by torch 0.0.1" in r.stderr


def test_a_failed_load_is_an_error_reply_when_lazy(host, artifact, tmp_path):
    """With ``--lazy`` a bucket loads at its first request: a package that
    cannot load is that request's error reply, and the host serves the next
    request from a good bucket; up front, it is a non-zero exit."""
    broken = _copy_artifact(artifact, tmp_path / "broken")
    (broken / "synth_b1_p32.aoti.pt2").unlink()
    (broken / "synth_b1_p32.aoti.pt2").write_bytes(b"not a package")
    long_text = "the quick brown fox jumps over the dog"
    ready, replies = _drive(
        host, broken,
        [f"synth\t{tmp_path}/l\t0\t0.0\t{long_text}",
         f"ids\t{tmp_path}/s\t0\t0.0\t4,9,12,9"],
        extra=("--device", "cpu", "--lazy"))
    assert ready["ready"] is True
    assert "error" in replies[0] and "synth_b1_p32" in replies[0]["error"]
    assert replies[1]["bucket"] == [1, 16] and replies[1]["n_frames"] > 0
    r = _run(host, "--artifact", broken, "--device", "cpu", timeout=120)
    assert r.returncode != 0 and "synth_b1_p32" in r.stderr
