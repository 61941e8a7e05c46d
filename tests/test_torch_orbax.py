"""The port's reader of the JAX package's orbax artifacts and checkpoints,
against the libraries it replaces, on the CPU.

* ``convert/zstd.py`` (the C++ RFC 8878 decoder) against ``zstandard``:
  levels -5, 1, 3 and 19; inputs of 0 B, 1 B, 1 KB, 200 KB and 3 MB
  (several blocks), incompressible bytes, long runs (RLE blocks), float16
  weight bytes; with and without a checksum and a content size;
  concatenated and skippable frames; the largest window the format can
  state; a hypothesis round trip; corrupt frames raise ``ValueError``.
* ``convert/ocdbt.py`` against tensorstore: multi-level B-trees, values
  inline and out of line, compressed and raw nodes, the latest of 20
  commits (older ones in version-tree nodes), numbered manifests; every
  key and value bitwise.
* ``convert/orbax.py`` against orbax: JAX's ``save_params`` on trees of
  every dtype a JAX train state holds, multi-chunk zarr arrays with
  missing chunks, and the released artifact (all 378 leaves bitwise, and
  its SHA-256 is ``chip_smoke.RELEASE_PARAMS_SHA256``).
* The port's ``TTSPipeline.load`` of JAX artifacts (the release, and
  ``save(half=False)`` / ``save(half=True)`` at a small config), the port's
  ``from_checkpoints`` on JAX stage checkpoints, and the entry points
  ``synthesize --artifact``, ``serve --pipeline`` and ``serve.export
  --pipeline`` on a JAX artifact, against the JAX package (the pipeline
  test's tolerance: max-abs <= 1e-3, equal lengths).
"""

import contextlib
import dataclasses
import hashlib
import http.client
import inspect
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import iris_tts_tpu_torch.config as tcfg
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.train.checkpoint import CheckpointManager as JManager
from iris_tts_tpu.train.checkpoint import load_params as jax_load_params
from iris_tts_tpu.train.checkpoint import save_params as jax_save_params
from iris_tts_tpu.train.state import TrainState as JTrainState
from iris_tts_tpu.train.state import adam_clipped
from iris_tts_tpu_torch.convert import ocdbt, orbax, zstd
from iris_tts_tpu_torch.convert.from_jax import state_dict_from_jax
from iris_tts_tpu_torch.models.pipeline import SynthesisModel, TTSPipeline
from iris_tts_tpu_torch.scripts import synthesize
from iris_tts_tpu_torch.serve import TTSServer
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab
from iris_tts_tpu_torch.serve import __main__ as serve_cli
from iris_tts_tpu_torch.serve import export as texport
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from iris_tts_tpu_torch.train.checkpoint import load_params
from tests.test_torch_pipeline import _assert_clear_of_half, _assert_same_audio
from tests.torch_port_utils import numpy_tree, small_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ARTIFACT = REPO / "release" / "pipeline_artifact"
LADDERS = dict(phoneme_buckets=(16, 32), frame_buckets=(32, 64, 128, 256))
TEXT = "Hello world, this is a test."


# -- zstd ----------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(0)
    wave = (np.sin(np.arange(3_000_000) / 50.0) * 100).astype(np.int8)
    return {
        "empty": b"",
        "one_byte": b"a",
        "1kb": rng.integers(0, 4, 1024, dtype=np.uint8).tobytes(),
        "200kb": rng.integers(0, 16, 200_000, dtype=np.uint8).tobytes(),
        "3mb": wave.tobytes(),
        "incompressible": rng.bytes(300_000),
        "runs": b"\x07" * 400_000 + b"abc" * 1000 + b"\x00" * 300_000,
        "float16": rng.standard_normal(200_000).astype(np.float16).tobytes(),
    }


INPUTS = _inputs()
LEVELS = (-5, 1, 3, 19)


def _frame(data: bytes, level: int, checksum: bool, content_size: bool):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    if content_size:
        return c.compress(data)
    obj = c.compressobj()  # streaming: the header states no size
    return obj.compress(data) + obj.flush()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_zstd_matches_zstandard(name, level):
    """Every frame kind of every input decodes to the input, and to what
    ``zstandard`` decodes, with and without a checksum and a content size."""
    data = INPUTS[name]
    for checksum in (False, True):
        for content_size in (False, True):
            frame = _frame(data, level, checksum, content_size)
            want = zstandard.ZstdDecompressor().decompressobj().decompress(
                frame)
            assert want == data
            assert zstd.decompress(frame) == data, (checksum, content_size)


def _block_types(frame: bytes):
    """The block types of a single frame (0 raw, 1 RLE, 2 compressed)."""
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1)
    fcs = fhd >> 6
    pos += (1 if fhd & 0x20 else 0) if fcs == 0 else 1 << fcs
    types = []
    while True:
        bh = frame[pos] | frame[pos + 1] << 8 | frame[pos + 2] << 16
        pos += 3
        types.append((bh >> 1) & 3)
        pos += 1 if (bh >> 1) & 3 == 1 else bh >> 3
        if bh & 1:
            return types


def test_zstd_inputs_cover_every_block_type():
    kinds = set()
    for data in INPUTS.values():
        for level in LEVELS:
            if data:
                kinds.update(_block_types(_frame(data, level, False, True)))
    assert kinds == {0, 1, 2}


def _skippable(payload: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", 0x184D2A50 + nibble, len(payload)) + payload


def test_zstd_concatenated_and_skippable_frames():
    parts = [INPUTS["1kb"], INPUTS["runs"], b"", INPUTS["float16"]]
    frames = [_frame(p, lvl, i % 2 == 0, i % 3 == 0)
              for i, (p, lvl) in enumerate(zip(parts, LEVELS))]
    blob = (_skippable(b"hello", 0) + frames[0] + frames[1]
            + _skippable(b"", 15) + frames[2] + frames[3]
            + _skippable(bytes(range(256)), 7))
    want = zstandard.ZstdDecompressor().decompressobj(
        read_across_frames=True).decompress(blob)
    assert zstd.decompress(blob) == b"".join(parts) == want
    assert zstd.decompress(_skippable(b"only")) == b""


def test_zstd_window_at_the_format_limit():
    """A frame whose window descriptor states the largest window (exponent
    31, mantissa 7: 3.75 TB): ``zstandard`` refuses it, the port decodes
    it (its output is held whole, whatever the window)."""
    data = INPUTS["200kb"]
    frame = bytearray(_frame(data, 3, True, False))
    assert frame[4] & 0x20 == 0  # a window descriptor follows
    frame[5] = 0xFF
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompressobj().decompress(bytes(frame))
    assert zstd.decompress(bytes(frame)) == data


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=20_000), level=st.sampled_from(LEVELS),
       repeat=st.integers(1, 40), checksum=st.booleans())
def test_zstd_round_trip(data, level, repeat, checksum):
    data = data * repeat
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_corrupt_frames_raise():
    data = INPUTS["200kb"]
    frame = _frame(data, 3, True, True)
    for cut in (1, 4, 5, 9, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" + frame[1:])
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(frame + b"junk")
    flipped = bytearray(frame)
    flipped[-1] ^= 0x01
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(flipped))
    with pytest.raises(ValueError, match="maximum"):
        zstd.decompress(frame, max_output_size=len(data) - 1)
    assert zstd.decompress(frame, max_output_size=len(data)) == data
    with pytest.raises(ValueError):
        zstd.decompress(b"")


@settings(max_examples=300, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), flips=st.integers(1, 8))
def test_zstd_mutated_frames_raise_or_decode(seed, flips):
    """Random byte flips in a valid frame (no checksum) end in a
    ``ValueError`` or some output, never a crash."""
    rng = np.random.default_rng(seed)
    frame = bytearray(_FUZZ_FRAMES[int(rng.integers(len(_FUZZ_FRAMES)))])
    for _ in range(flips):
        frame[int(rng.integers(len(frame)))] = int(rng.integers(256))
    try:
        out = zstd.decompress(bytes(frame), max_output_size=1 << 22)
    except ValueError:
        return
    assert len(out) <= 1 << 22


_FUZZ_FRAMES = [_frame(INPUTS[n][:50_000], lvl, False, cs)
                for n, lvl, cs in (("1kb", 19, True), ("float16", 3, False),
                                   ("200kb", 1, True), ("runs", -5, False))]


def test_zstd_has_no_fallback_without_a_compiler(monkeypatch, tmp_path):
    """With no library built for the source and ``CXX`` naming a compiler
    that does not exist, the reader raises, naming the compiler."""
    src = tmp_path / "zstd_decode.cpp"
    src.write_text(zstd.SOURCE.read_text() + "\n// another build\n")
    monkeypatch.setattr(zstd, "SOURCE", src)
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        zstd.decompress(_frame(b"abc", 1, False, True))
    with pytest.raises(RuntimeError, match="no-such-g"):
        orbax.read_tree(ARTIFACT / "params")


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283  # CRC-32C's check value
    assert zstd.crc32c(b"") == 0


# -- OCDBT -----------------------------------------------------------------------


def _write_db(path, config, commits, keys_per_commit, value_len=10,
              seed=0, **spec):
    rng = np.random.default_rng(seed)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": config, **spec}).result()
    for c in range(commits):
        with ts.Transaction() as txn:
            for k in range(keys_per_commit):
                n = int(rng.integers(0, value_len + 1))
                kv.with_transaction(txn).write(
                    f"k{c:03d}/{k:05d}", rng.bytes(n)).result()
    return kv


def _assert_same_db(path, kv=None):
    kv = kv or ts.KvStore.open({"driver": "ocdbt",
                                "base": f"file://{path}"}).result()
    want = sorted(k.decode() for k in kv.list().result())
    reader = ocdbt.OcdbtReader(path)
    assert reader.list() == want and want
    for k in want:
        assert reader.read(k) == kv.read(k).result().value, k
    first = want[0].split("/")[0] + "/"
    assert reader.list(first) == [k for k in want if k.startswith(first)]
    assert reader.list("zzz") == []
    with pytest.raises(KeyError):
        reader.read(want[0] + "-missing")
    return reader


DB_CASES = {
    "tiny_nodes_zstd": (dict(max_decoded_node_bytes=256,
                             max_inline_value_bytes=0,
                             compression={"id": "zstd", "level": 3}), 1, 300),
    "tiny_nodes_raw": (dict(max_decoded_node_bytes=300,
                            max_inline_value_bytes=0, compression=None), 3,
                       80),
    "inline_1mb": (dict(max_inline_value_bytes=1 << 20,
                        compression={"id": "zstd", "level": -5}), 2, 50),
    "twenty_commits": (dict(compression={"id": "zstd"}), 20, 3),
}


@pytest.mark.parametrize("case", sorted(DB_CASES))
def test_ocdbt_matches_tensorstore(case, tmp_path):
    config, commits, keys = DB_CASES[case]
    kv = _write_db(tmp_path / "db", config, commits, keys,
                   value_len=2000 if "inline" in case else 40)
    reader = _assert_same_db(tmp_path / "db", kv)
    if case.startswith("tiny"):
        assert reader.root.height >= 2  # interior nodes were walked
    if case == "twenty_commits":
        # more versions than the manifest's 16 inline: older ones went to
        # version-tree nodes, and the latest is still read
        assert reader.root.generation > 16


def test_ocdbt_numbered_manifest(tmp_path):
    _write_db(tmp_path / "db", {"manifest_kind": "numbered"}, 4, 5)
    assert list((tmp_path / "db").glob("manifest.0*"))
    _assert_same_db(tmp_path / "db")


def test_ocdbt_corrupt_node_raises(tmp_path):
    _write_db(tmp_path / "db", {"compression": {"id": "zstd"}}, 1, 20)
    reader = ocdbt.OcdbtReader(tmp_path / "db")
    node = tmp_path / "db" / reader.root.ref.file
    data = bytearray(node.read_bytes())
    data[reader.root.ref.offset + 20] ^= 0xFF
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtReader(tmp_path / "db").list()
    (tmp_path / "db" / "manifest.ocdbt").write_bytes(b"\x00" * 30)
    with pytest.raises(ValueError, match="magic"):
        ocdbt.OcdbtReader(tmp_path / "db")


# -- orbax -----------------------------------------------------------------------


def _same_leaf(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_leaf(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_leaf(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    elif isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, path
    else:
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor), path
            assert got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == want.shape, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=path)
        else:
            assert isinstance(got, np.ndarray), path
            assert (got.dtype, got.shape) == (want.dtype, want.shape), path
            assert got.tobytes() == want.tobytes(), path


def _all_dtypes_tree():
    rng = np.random.default_rng(1)
    return {
        "f2": rng.standard_normal((3, 5)).astype(np.float16),
        "f4": jnp.asarray(rng.standard_normal((4, 6, 2)), jnp.float32),
        "f8": rng.standard_normal(7),
        "i4": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
        "i8": np.int64(2**40) * np.arange(3),
        "u4": jax.random.key_data(jax.random.PRNGKey(7)),
        "b1": np.array([[True, False, True]]),
        "bf16": jnp.asarray(rng.standard_normal(9), jnp.bfloat16),
        "scalar_array": jnp.int32(11),
        "py_int": 5,
        "py_float": 0.25,
        "nested": {"none": None, "empty": {}, "no_list": [], "no_tuple": (),
                   "seq": [np.ones(2), {
            "deep": np.zeros((2, 3), np.float32)}]},
    }


def test_read_tree_every_dtype(tmp_path):
    tree = _all_dtypes_tree()
    jax_save_params(tmp_path / "ck", tree)
    assert orbax.is_orbax_checkpoint(tmp_path / "ck")
    _same_leaf(orbax.read_tree(tmp_path / "ck"),
               jax_load_params(tmp_path / "ck"), "")


@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 5}])
def test_read_array_chunks_and_fill(tmp_path, compressor):
    """A zarr-v2 array in several chunks, edge chunks partial, two chunks
    never written (they read as ``fill_value``)."""
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/db"}
    arr = ts.open({"driver": "zarr", "kvstore": {**kv, "path": "x/"},
                   "metadata": {"shape": [7, 10], "chunks": [3, 4],
                                "dtype": "<f4", "fill_value": -2.5,
                                "compressor": compressor},
                   "create": True}).result()
    data = np.arange(70, dtype=np.float32).reshape(7, 10)
    arr[:3, :].write(data[:3]).result()
    arr[6:, 8:].write(data[6:, 8:]).result()
    arr[3:6, :4].write(data[3:6, :4]).result()
    want = arr.read().result()
    reader = ocdbt.OcdbtReader(tmp_path / "db")
    assert len([k for k in reader.list("x/") if k != "x/.zarray"]) < 9
    got = orbax.read_array(reader, "x")
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (got == -2.5).any()


@pytest.mark.parametrize("meta, what", [
    ({"dtype": "<i2"}, "dtype"),
    ({"dtype": "<f4", "order": "F", "shape": [2, 2], "chunks": [2, 2]},
     "order")])
def test_read_array_refuses_what_orbax_does_not_write(tmp_path, meta, what):
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/db"}
    arr = ts.open({"driver": "zarr", "kvstore": {**kv, "path": "x/"},
                   "metadata": {"shape": [4], "chunks": [4], **meta},
                   "create": True}).result()
    arr.write(np.arange(4).astype(arr.dtype.numpy_dtype).reshape(
        arr.shape)).result()
    with pytest.raises(ValueError, match=what):
        orbax.read_array(ocdbt.OcdbtReader(tmp_path / "db"), "x")


# -- the released artifact ---------------------------------------------------------
# (tests/test_torch_release.py holds the port's load of it against JAX's
# TTSPipeline.load, bitwise, and runs every release test on that load)


def test_release_tree_is_orbax_bitwise():
    got = orbax.read_tree(ARTIFACT / "params")
    want = jax_load_params(ARTIFACT / "params")
    assert len(jax.tree_util.tree_leaves(want)) == 378
    _same_leaf(got, want, "")
    assert orbax.tree_sha256(numpy_tree(want)) == \
        chip_smoke.RELEASE_PARAMS_SHA256
    assert orbax.tree_sha256(got) == chip_smoke.RELEASE_PARAMS_SHA256


def state_sha256(sd) -> str:
    """SHA-256 of a state dict: keys in order, each key, dtype and bytes."""
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode() + str(sd[k].dtype).encode() + sd[k].contiguous()
                 .reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def test_release_load_without_jax():
    """In a process that never imports jax, orbax, tensorstore or
    zstandard, the port decodes the artifact to the digest of orbax's
    restore and loads a state dict bitwise equal to ``from_jax_params`` of
    the tree orbax restores (cast to float32, as JAX's ``load`` casts a
    float16 artifact)."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_load_params(ARTIFACT / "params"))
    config = tcfg.load_config(ARTIFACT / "config.json")
    want = TTSPipeline.from_jax_params(
        tree, config, device="cpu",
        vocab=PhonemeVocab.load(ARTIFACT / "vocab.json")).model.state_dict()
    code = (
        "import hashlib, sys, torch\n"
        "from iris_tts_tpu_torch.models.pipeline import TTSPipeline\n"
        "from iris_tts_tpu_torch.convert.orbax import read_tree, "
        "tree_sha256\n"
        + inspect.getsource(state_sha256) +
        f"p = TTSPipeline.load({str(ARTIFACT)!r}, device='cpu')\n"
        f"t = tree_sha256(read_tree({str(ARTIFACT / 'params')!r}))\n"
        "bad = [m for m in ('jax', 'flax', 'orbax', 'tensorstore', "
        "'zstandard') if m in sys.modules]\n"
        "print(state_sha256(p.model.state_dict()), t, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    state, digest, bad = r.stdout.split(maxsplit=2)
    assert bad.strip() == "[]"
    assert digest == chip_smoke.RELEASE_PARAMS_SHA256
    assert state == state_sha256(want)


# -- JAX artifacts and checkpoints at a small config -------------------------------


@pytest.fixture(scope="module")
def jax_small():
    """A JAX pipeline at ``small_config()`` with order-one audio (HiFiGAN
    kernels scaled) and short ladders."""
    jpipe = JPipeline.initialize(small_config(), seed=3)
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **LADDERS)
    _assert_clear_of_half(jpipe, [TEXT])
    return jpipe


@contextlib.contextmanager
def _reusing(jpipe):
    """JAX's ``initialize`` (flax's init of every module, tens of seconds
    on the CPU) replaced by a copy of ``jpipe``, whose config, vocab and
    options are the ones asked for: JAX's ``load`` and ``from_checkpoints``
    then run their own restore code over it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPipeline, "initialize", classmethod(
            lambda cls, *a, **kw: dataclasses.replace(
                jpipe, params=dict(jpipe.params))))
        yield


def _jax_audio(jpipe, params, text=TEXT):
    """JAX's fused synthesis at temperature 0 on ``params``, through
    ``jpipe``'s compiled functions."""
    kept = jpipe.params
    jpipe.params = params
    try:
        return jpipe.synthesize(text, temperature=0.0)
    finally:
        jpipe.params = kept


@pytest.fixture(scope="module")
def artifacts(jax_small, tmp_path_factory):
    """JAX ``save(half=False)`` and ``save(half=True)`` artifacts, each with
    JAX's ``load`` of it and that load's audio."""
    root = tmp_path_factory.mktemp("jax_artifacts")
    out = {}
    for half in (False, True):
        art = root / f"half_{half}"
        jax_small.save(art, half=half)
        with _reusing(jax_small):
            params = JPipeline.load(art).params
        out[half] = (art, numpy_tree(params), _jax_audio(jax_small, params))
    return out


@pytest.mark.parametrize("half", [False, True])
def test_jax_artifact_loads_and_synthesizes(artifacts, half):
    art, params, want = artifacts[half]
    assert orbax.is_orbax_checkpoint(art / "params")
    pipe = TTSPipeline.load(art, device="cpu")
    ref = TTSPipeline.from_jax_params(params, pipe.config, device="cpu")
    got = pipe.model.state_dict()
    for k, v in ref.model.state_dict().items():
        assert torch.equal(got[k], v), k
    assert (pipe.phoneme_buckets, pipe.frame_buckets) == (
        LADDERS["phoneme_buckets"], LADDERS["frame_buckets"])
    _assert_same_audio(pipe.synthesize(TEXT, temperature=0.0), want)


def test_jax_artifact_shape_mismatch_raises(artifacts, tmp_path):
    art = tmp_path / "art"
    shutil.copytree(artifacts[False][0], art)
    cfg = json.loads((art / "config.json").read_text())
    cfg["postnet"]["channels"] *= 2
    (art / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="shape"):
        TTSPipeline.load(art, device="cpu")


def test_load_params_reads_orbax(artifacts):
    art = artifacts[False][0]
    tree = load_params(art / "params")
    assert set(tree) == {"encoder", "duration", "vae", "postnet", "hifigan"}
    pipe = TTSPipeline.load(art, device="cpu")
    model = load_params(art / "params", template=SynthesisModel(pipe.config))
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.fixture(scope="module")
def jax_stages(jax_small, tmp_path_factory):
    """JAX stage checkpoint directories over ``jax_small``'s weights: the
    encoder with a best state and a later, worse step; the VAE with its
    latest step only; the PostNet with moved batch statistics; the GAN
    generator with an EMA average apart from its params."""
    root = tmp_path_factory.mktemp("jax_stages")
    cfg, p = jax_small.config, jax_small.params
    key = jax.random.PRNGKey(0)

    def bump(tree, d):
        return jax.tree_util.tree_map(lambda a: a + d, tree)

    def save(name, step, state, val=None):
        mgr = JManager(root / name, cfg)
        mgr.save(step, state, val_metric=val, wait=True)
        mgr.close()

    def state(params, **kw):
        return JTrainState.create(params, adam_clipped(1e-3), key, **kw)

    enc = {"encoder": p["encoder"], "duration": p["duration"]}
    save("enc", 1, state(enc), val=1.0)
    save("enc", 2, state(bump(enc, 0.5)))  # the latest, not the best
    save("vae", 3, state(p["vae"], frozen={"encoder": p["encoder"]}))
    save("pn", 1, state(p["postnet"]["params"], batch_stats=bump(
        p["postnet"]["batch_stats"], 0.25)), val=0.5)
    gan = state(p["hifigan"], ema_decay=0.5)
    save("gan", 1, gan.apply_gradients(jax.tree_util.tree_map(
        jnp.ones_like, gan.params)))
    return root


def test_checkpoint_manager_reads_jax_stages(jax_stages, jax_small):
    enc = CheckpointManager(jax_stages / "enc")
    assert enc.all_steps() == [1, 2] and enc.latest_step() == 2
    raw = enc.restore_raw(2)
    assert "batch_stats" in raw and "opt_state" in raw
    _same_leaf(raw, JManager(jax_stages / "enc").restore_raw(2), "")
    best = enc.restore_best_params()
    np.testing.assert_array_equal(
        best["duration"]["conv_0"]["bias"],
        np.asarray(jax_small.params["duration"]["conv_0"]["bias"]))
    _same_leaf(CheckpointManager(jax_stages / "pn").restore_best_raw(),
               JManager(jax_stages / "pn").restore_best_raw(), "")
    with pytest.raises(ValueError, match="JAX train state"):
        enc.restore(object())


def test_from_checkpoints_on_jax_stages(jax_stages, jax_small):
    """The port's ``from_checkpoints`` over JAX stage directories builds
    the weights JAX's ``from_checkpoints`` builds, bitwise: the best
    encoder, the latest VAE, the PostNet with its batch statistics, the
    GAN's EMA generator."""
    with _reusing(jax_small):
        jpipe = JPipeline.from_checkpoints(
            jax_stages / "enc", jax_stages / "vae",
            postnet_checkpoint=jax_stages / "pn",
            hifigan_gan_checkpoint=jax_stages / "gan",
            config=jax_small.config)
    pipe = TTSPipeline.from_checkpoints(
        jax_stages / "enc", jax_stages / "vae", jax_stages / "pn",
        hifigan_gan_checkpoint=jax_stages / "gan", device="cpu")
    want = state_dict_from_jax(numpy_tree(jpipe.params))
    got = pipe.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(
        got["hifigan.conv_post.weight"],
        state_dict_from_jax({"hifigan": numpy_tree(
            jax_small.params["hifigan"])})["hifigan.conv_post.weight"])


# -- the entry points on a JAX artifact ----------------------------------------------


def test_synthesize_cli_on_a_jax_artifact(artifacts, tmp_path):
    art, _, want = artifacts[True]
    out = tmp_path / "a.wav"
    audio = synthesize.main(["--artifact", str(art), "--text", TEXT,
                             "--temperature", "0", "--output_wav", str(out),
                             "--device", "cpu"])
    _assert_same_audio(audio, want)
    assert out.stat().st_size == 44 + 2 * len(audio)


def test_serve_cli_on_a_jax_artifact(artifacts, monkeypatch):
    """``python -m iris_tts_tpu_torch.serve --pipeline`` (in-process, its
    server started on a free port) answers a request with the JAX
    pipeline's audio, within the pipeline test's tolerance plus one PCM16
    step."""
    art, _, want = artifacts[False]
    seen = {}

    def serve(pipe, host, port, **kw):
        srv = TTSServer(pipe, host="127.0.0.1", port=0, max_batch=1,
                        max_wait_ms=1.0)
        srv.start()
        try:
            conn = http.client.HTTPConnection(*srv.address, timeout=120)
            conn.request("POST", "/synthesize", body=json.dumps(
                {"text": TEXT, "temperature": 0.0}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            seen["status"], seen["body"] = resp.status, resp.read()
            conn.close()
        finally:
            srv.stop()

    monkeypatch.setattr(serve_cli, "serve_forever", serve)
    serve_cli.main(["--pipeline", str(art), "--device", "cpu"])
    assert seen["status"] == 200
    pcm = np.frombuffer(seen["body"][44:], "<i2") / 32767.0
    assert len(pcm) == len(want)
    assert float(np.abs(pcm - want).max()) <= 1e-3 + 1 / 32767


def test_export_cli_on_a_jax_artifact(artifacts, tmp_path):
    from iris_tts_tpu_torch.serve.export import AotPipeline

    art, _, want = artifacts[False]
    texport.main(["--pipeline", str(art), "--output", str(tmp_path / "aot"),
                  "--device", "cpu", "--batch_sizes", "1",
                  "--phoneme_buckets", "32"])
    aot = AotPipeline(tmp_path / "aot", device="cpu")
    _assert_same_audio(aot.synthesize(TEXT, temperature=0.0), want)
