"""Multi-device synthesis of the port on two gloo ranks: ``use_mesh``
(fused and two-stage, with a pad row), ``vocode_sharded`` and the
pipeline split, against the port in one process and against JAX's mesh
paths (after ``tests/test_parallel.py``).

One group of two ranks (``tests/torch_mesh_ranks.py``) runs every check on
the pipeline this module saves; the references run here meanwhile. Seeds
do not cross the packages, so the JAX comparisons run at temperature 0
(the prior sample is exactly zero in both) on weights carried over with
``from_jax_params``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from iris_tts_tpu.config import MeshConfig as JMeshConfig
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.parallel.mesh import build_mesh as jbuild_mesh
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
from tests import torch_mesh_ranks as R
from tests.test_torch_pipeline import BUCKETS, _assert_clear_of_half
from tests.torch_port_utils import max_abs, numpy_tree, port_config, small_config

torch.set_num_threads(2)

# Cross-shape comparisons (a rank's rows or window against the whole):
# convolution algorithms are picked per shape, so ≤ 1e-5 of the peak.
SHAPE_LIMIT = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_synth")
    jpipe = JPipeline.initialize(small_config(), seed=3)
    # audible audio at this width, as the pipeline parity tests scale it
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **BUCKETS)
    pipe = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    pipe = dataclasses.replace(pipe, **BUCKETS)
    pipe.save(work / "pipe")
    group = R.start_ranks("synth", work, 2, deadline_s=150)

    ref = TTSPipeline.load(work / "pipe", device="cpu")
    mels = R.vocode_mels(ref.config.hifigan.in_channels)
    want = {
        "staged": ref.synthesize(R.PIPE_TEXTS, seed=11, temperature=0.667,
                                 fused=False),
        "fused": ref.synthesize(R.PIPE_TEXTS, seed=12, temperature=0.667,
                                fused=True),
        "mel_t0": ref.synthesize_mel(R.PIPE_TEXTS[:3], temperature=0.0),
        "pp_batches": [ref.synthesize(b, seed=3, fused=True)
                       for b in R.PP_BATCHES],
        "pp_pcm16": ref.synthesize("quantized on device", seed=1,
                                   fused=True, pcm16=True),
        "pp_single": ref.synthesize("hello world", seed=3, fused=True),
    }
    for t in R.VOCODE_LENGTHS:
        want[f"vocode_{t}"] = ref.vocode(mels[t])
    want["vocode_pcm16"] = host_pcm16(ref.vocode(mels["pcm16"]))
    want["vocode_short"] = ref.vocode(mels["short"])
    want["vocode_batch"] = ref.vocode(np.stack([mels[200]] * 2))

    _assert_clear_of_half(jpipe, R.PIPE_TEXTS)
    jmesh = jbuild_mesh(JMeshConfig(data_parallel=2),
                        jax.devices()[:2])
    jpipe.use_mesh(jmesh)
    jax_want = {
        "staged_t0": jpipe.synthesize(R.PIPE_TEXTS, temperature=0.0,
                                      fused=False),
        "fused_t0": jpipe.synthesize(R.PIPE_TEXTS, temperature=0.0,
                                     fused=True),
    }
    for t in R.VOCODE_LENGTHS:
        jax_want[f"vocode_{t}"] = jpipe.vocode_sharded(mels[t], jmesh)
    # the shapes the warmups run in one process (stage A per phoneme
    # bucket, stage B per frame bucket up to 2 frames a phoneme, the
    # smallest always)
    batched = sum(1 + sum(1 for i, t in enumerate(ref.frame_buckets)
                          if i == 0 or t <= 2 * p)
                  for p in ref.phoneme_buckets)
    return {"want": want, "jax": jax_want, "mesh": group.join(),
            "pairs": ref.fused_bucket_pairs(20), "batched_shapes": batched}


def _assert_rows(got, want, limit=SHAPE_LIMIT):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        peak = float(np.abs(w).max())
        assert peak > 0.05
        assert max_abs(g, w) <= limit * peak


def _assert_parity(got, want):
    """The pipeline parity tests' tolerance against JAX (≤ 1e-3)."""
    assert got.shape == want.shape
    assert float(np.abs(want).max()) > 0.05
    assert max_abs(got, want) <= 1e-3


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_use_mesh_matches_one_process(runs, path):
    """Five texts over two ranks (a pad row) at temperature 0.667 with a
    seed: every rank returns all five rows, equal to the one-process call
    within JAX's mesh tolerance (2e-5)."""
    want = runs["want"][path]
    for rank in runs["mesh"]:
        got = rank[path]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("path", ["staged_t0", "fused_t0"])
def test_use_mesh_matches_jax_use_mesh(runs, path):
    """At temperature 0 on weights carried from JAX: the port's two-rank
    mesh against JAX's ``use_mesh`` on a 2×1 mesh."""
    want = runs["jax"][path]
    for rank in runs["mesh"]:
        got = rank[path]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _assert_parity(g, w)


def test_synthesize_mel_on_the_mesh(runs):
    for rank in runs["mesh"]:
        _assert_rows(rank["mel_t0"], runs["want"]["mel_t0"])


@pytest.mark.parametrize("t", R.VOCODE_LENGTHS)
def test_vocode_sharded_matches_vocode_and_jax(runs, t):
    """One window a rank at T = 200, 203 (uneven) and 230 (pads to
    chunk · 2): the whole waveform on every rank, within 1e-5 of the peak
    of ``vocode`` and at the parity tolerance of JAX's
    ``vocode_sharded``."""
    up = 256
    for rank in runs["mesh"]:
        got = rank[f"vocode_{t}"]
        assert got.shape == (t * up,)
        _assert_rows([got], [runs["want"][f"vocode_{t}"]])
        _assert_parity(got, runs["jax"][f"vocode_{t}"])


def test_vocode_sharded_pcm16_batch_and_short_mel(runs):
    """PCM16 quantized on the device (one LSB of rounding noise at most),
    a batch of two mels, and a mel shorter than a window (the plain
    ``vocode``, bitwise)."""
    want = runs["want"]
    for rank in runs["mesh"]:
        got16 = rank["vocode_pcm16"]
        assert got16.dtype == np.int16
        assert np.abs(got16.astype(np.int32)
                      - want["vocode_pcm16"].astype(np.int32)).max() <= 1
        _assert_rows(list(rank["vocode_batch"]), list(want["vocode_batch"]))
        np.testing.assert_array_equal(rank["vocode_short"],
                                      want["vocode_short"])


def test_warmups_run_the_same_shapes_on_every_rank(runs):
    """``warmup_fused`` and ``warmup_batched`` on the mesh (batch 3: a pad
    row) run every shape on both ranks and come back with one process's
    counts: a fused shape per (phoneme, frame) bucket pair and batch size;
    stage A per phoneme bucket plus stage B per reachable frame bucket."""
    counts = [r["warmup"] for r in runs["mesh"]]
    assert counts[0] == counts[1]
    fused, batched = counts[0]
    assert fused == 2 * len(runs["pairs"])
    assert batched == runs["batched_shapes"]


def test_pipeline_split_matches_fused_synthesis(runs):
    """``PipelineParallelSynthesizer(split=1)``: three batches streamed
    through both stages with two in flight equal the fused path (atol
    1e-6, rtol 1e-5, as JAX); PCM16 on stage 2; a bare string is one
    waveform."""
    want = runs["want"]
    for rank in runs["mesh"]:
        got = rank["pp_batches"]
        assert [len(g) for g in got] == [2, 4, 1]
        for outs, w in zip(got, want["pp_batches"]):
            w = [w] if isinstance(w, np.ndarray) else w
            for g, ww in zip(outs, w):
                assert g.shape == ww.shape
                np.testing.assert_allclose(g, ww, atol=1e-6, rtol=1e-5)
        assert rank["pp_pcm16"][0].dtype == np.int16
        np.testing.assert_allclose(rank["pp_pcm16"][0].astype(np.int32),
                                   want["pp_pcm16"].astype(np.int32),
                                   atol=1)
        assert isinstance(rank["pp_single"], np.ndarray)
        np.testing.assert_allclose(rank["pp_single"], want["pp_single"],
                                   atol=1e-6, rtol=1e-5)


def test_pipeline_split_parameters_are_stage_exclusive(runs):
    stage1, stage2 = (set(r["pp_keys"]) for r in runs["mesh"])
    assert stage1 and not any(k.startswith("hifigan.") for k in stage1)
    assert {k.split(".")[0] for k in stage1} == {
        "encoder", "duration", "vae", "postnet"}
    assert stage2 and all(k.startswith("hifigan.") for k in stage2)


def test_every_path_took_all_reduce_or_broadcast(runs):
    """The row gathers, the window gather and the stage handoff are
    all-reduces into zero-filled buffers (what gloo takes on CUDA tensors
    too); no path used another collective."""
    for rank in runs["mesh"]:
        calls = rank["collectives"]
        paths = {path for (path, _, _) in calls}
        assert {"use_mesh", "vocode_sharded", "pp_handoff",
                "pp_gather", "frame_bucket"} <= paths
        assert {op for (_, op, _) in calls} <= {"all_reduce", "broadcast"}
        assert {b for (_, _, b) in calls} == {"gloo"}
