"""The model axis of the port (tensor parallelism) on a 2×2 (data, model)
mesh of four gloo ranks, against the port in one process and against the
JAX package's model axis (after ``tests/test_parallel.py:52-164, 238-244,
306``, which runs 4×2 on 8 virtual devices).

One group of four ranks (``tests/torch_mesh_ranks.py``, scenario ``tp``)
runs every check; the one-process references and the JAX values run here
meanwhile. Seeds do not cross the packages, so the JAX comparisons of
synthesis run at temperature 0 on weights carried over with
``from_jax_params``. The training checks use SGD (updates linear in the
gradients), compare the gradients leaf by leaf as well as the params, and
repeat each stage's steps with the model axis' input-gradient sum planted
out, which must read above the limit.
"""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from iris_tts_tpu.config import MeshConfig as JMeshConfig
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.parallel.mesh import build_mesh as jbuild_mesh
from iris_tts_tpu.parallel.sharding import tp_param_sharding as jshard
from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.convert.from_jax import _convert_leaf
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import Dense, init_params
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
from iris_tts_tpu_torch.runtime import seeded_generator
from iris_tts_tpu_torch.scripts import train_encoder
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from tests import torch_mesh_ranks as R
from tests.corpus_utils import build_mini_corpus
from tests.test_torch_parallel_synth import SHAPE_LIMIT, _assert_parity
from tests.test_torch_parallel_train import _cases
from tests.test_torch_pipeline import BUCKETS
from tests.test_torch_scripts import SMALL_CFG
from tests.torch_port_utils import max_abs, numpy_tree, port_config, small_config

torch.set_num_threads(2)

# Model-axis steps against one process: JAX's own 4×2 tolerance (:306).
PARAMS_ATOL = 2e-5
# A gradient leaf against one process's, as a share of the update's
# largest |g| (the sums run in another order; the planted fault reads
# 1e-1 or more of it on these cases).
GRAD_SHARE = 1e-5


def _jax_sharded(tree, mesh, cfg, postnet_level: bool = False) -> set:
    """The port's state-dict keys of the leaves JAX's rule shards."""
    placed = jshard(tree, mesh, cfg)
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        if postnet_level and keys[0] == "postnet":
            keys = keys[:1] + keys[2:]  # params / batch_stats
        if "model" in str(leaf.sharding.spec):
            out.add(_convert_leaf(keys, np.empty(leaf.shape, np.float32))[0])
    return out


def _jax_leaf_sets(jpipe, jmesh, jcfg) -> dict:
    from iris_tts_tpu.models.discriminators import (
        HiFiGANDiscriminators as JDisc,
    )
    from iris_tts_tpu.models.hifigan import HiFiGANGenerator as JGen
    from iris_tts_tpu.config import HiFiGANConfig as JHiFiGANConfig
    from tests.test_gan import _CFG as gan_cfg
    from tests.test_train_steps import _init_duration_state

    key = jax.random.PRNGKey(0)
    audio = np.zeros((1, 2048), np.float32)
    disc = JDisc(periods=(2,), num_scales=1, width=0.125)
    gen = JGen(config=gan_cfg.hifigan)
    mel = np.zeros((1, 8, gan_cfg.hifigan.in_channels), np.float32)
    big = JGen(config=JHiFiGANConfig())
    big_mel = np.zeros((1, 4, 80), np.float32)
    return {
        "pipe": _jax_sharded(jpipe.params, jmesh, jcfg, postnet_level=True),
        "duration": _jax_sharded(_init_duration_state(key).params, jmesh,
                                 jcfg),
        "gan_gen": _jax_sharded(gen.init(key, mel)["params"], jmesh, jcfg),
        "gan_disc": _jax_sharded(disc.init(key, audio)["params"], jmesh,
                                 jcfg),
        "hifigan": _jax_sharded(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(big.init, key, big_mel)["params"]), jmesh, jcfg),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_tp")
    jpipe = JPipeline.initialize(small_config(), seed=3)
    plain = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    dataclasses.replace(plain, phoneme_buckets=(16, 32, 64),
                        frame_buckets=(16, 32, 64, 128, 256, 512)).save(
        work / "pipe_plain")
    # audible audio at this width, as the pipeline parity tests scale it
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **BUCKETS)
    pipe = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    dataclasses.replace(pipe, **BUCKETS).save(work / "pipe")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    dense = Dense(16, 32)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(
            rng.standard_normal((32, 16)).astype(np.float32)))
    torch.save({"x": x, "dense": dense.state_dict()}, work / "matmul.pt")
    hg_mel = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 24, 80)).astype(np.float32))
    torch.save(hg_mel, work / "hifigan_mel.pt")
    cases, _ = _cases()
    cases = {k: cases[k] for k in ("duration", "vae", "postnet", "gan")}
    torch.save(cases, work / "train_cases.pt")
    one = R.tp_state(cases["duration"], adam=True)
    R.tp_adam_steps(one, cases["duration"], 1)
    CheckpointManager(work / "ckpt_one").save(1, one)

    group = R.start_ranks("tp", work, 4, deadline_s=300)

    ref = TTSPipeline.load(work / "pipe", device="cpu")
    mels = R.vocode_mels(ref.config.hifigan.in_channels)
    want = {
        "staged": ref.synthesize(R.PIPE_TEXTS, seed=11, temperature=0.667,
                                 fused=False),
        "fused": ref.synthesize(R.PIPE_TEXTS, seed=12, temperature=0.667,
                                fused=True),
        "mel_t0": ref.synthesize_mel(R.PIPE_TEXTS[:3], temperature=0.0),
        "whole_bytes": sum(p.numel() * p.element_size()
                           for p in ref.model.parameters()),
        "sd": ref.model.state_dict(),
    }
    for t in R.VOCODE_LENGTHS:
        want[f"vocode_{t}"] = ref.vocode(mels[t])
    want["vocode_pcm16"] = host_pcm16(ref.vocode(mels["pcm16"]))
    p32 = TTSPipeline.load(work / "pipe_plain", device="cpu")
    want["bf16_f32"] = p32.synthesize(R.GATE_TEXT, seed=7, temperature=0.0,
                                      return_mel=True)
    gen = HiFiGANGenerator(HiFiGANConfig())
    init_params(gen, seeded_generator(0, "cpu"))
    with torch.no_grad():
        want["hifigan"] = gen(hg_mel)
    del gen
    with torch.no_grad():
        want["matmul"] = x @ dense.weight.T + dense.bias
    single = {name: R.run_train_case(case) for name, case in cases.items()}
    batched = sum(1 + sum(1 for i, t in enumerate(ref.frame_buckets)
                          if i == 0 or t <= 2 * p)
                  for p in ref.phoneme_buckets)

    jcfg = JMeshConfig(data_parallel=4, model_parallel=2)
    jmesh = jbuild_mesh(jcfg, jax.devices())
    leaves = _jax_leaf_sets(jpipe, jmesh, jcfg)
    jpipe.use_mesh(jmesh, jcfg)
    jax_want = {
        "staged_t0": jpipe.synthesize(R.PIPE_TEXTS, temperature=0.0,
                                      fused=False),
        "fused_t0": jpipe.synthesize(R.PIPE_TEXTS, temperature=0.0,
                                     fused=True),
    }
    mesh = group.join()
    return {"want": want, "jax": jax_want, "leaves": leaves, "mesh": mesh,
            "single": single, "cases": cases, "work": work,
            "pairs": ref.fused_bucket_pairs(20), "batched_shapes": batched,
            "one_ckpt": one.state_dict()}


def test_the_ranks_form_a_2x2_mesh(runs):
    """World rank r sits at (r // 2, r % 2), as JAX's ``reshape(dp, mp)``."""
    assert [r["coords"] for r in runs["mesh"]] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    assert all(r["shape"] == {"data": 2, "model": 2} for r in runs["mesh"])


@pytest.mark.parametrize("which,key", [
    ("pipe", "pipe_sharded"), ("duration", "duration_state_sharded"),
    ("gan_gen", "gan_gen_sharded"), ("gan_disc", "gan_disc_sharded"),
    ("hifigan", "hifigan_sharded")])
def test_sharded_leaves_are_jaxs(runs, which, key):
    """The leaves the port shards are the ones JAX's ``tp_param_sharding``
    shards on a model axis of two, under ``convert/from_jax.py``'s names
    (after ``tests/test_parallel.py:52``): the small pipeline, the
    duration state, both GAN states and the production HiFiGAN."""
    want = runs["leaves"][which]
    assert want
    for rank in runs["mesh"]:
        assert set(rank[key]) == want


def test_sharded_matmul_matches_single_device(runs):
    """A dense layer with its 32 output columns over the model axis and
    the 8 rows over the data axis equals ``x @ w`` (after
    ``tests/test_parallel.py:66``)."""
    for rank in runs["mesh"]:
        assert rank["matmul_weight_shape"] == (16, 16)
        np.testing.assert_allclose(rank["matmul"].numpy(),
                                   runs["want"]["matmul"].numpy(), atol=1e-5)


def test_parameter_bytes_a_rank(runs):
    """Each rank holds half of every sharded leaf and all of the rest."""
    sd = runs["want"]["sd"]
    for rank in runs["mesh"]:
        half = sum(sd[k].numel() * 4 for k in rank["pipe_sharded"]) // 2
        assert rank["pipe_bytes"] == runs["want"]["whole_bytes"] - half
        assert half > 0


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_use_mesh_model_parallel_matches_one_process(runs, path):
    """Five texts (a pad row) at temperature 0.667 with a seed on the 2×2
    mesh: every rank returns all five rows, within JAX's model-axis
    tolerance (2e-5) of the one-process call (after
    ``tests/test_parallel.py:127``)."""
    want = runs["want"][path]
    for rank in runs["mesh"]:
        got = rank[path]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("path", ["staged_t0", "fused_t0"])
def test_use_mesh_model_parallel_matches_jax_use_mesh(runs, path):
    """At temperature 0 on weights carried from JAX: the port's 2×2 mesh
    against JAX's ``use_mesh`` on a 4×2 mesh."""
    want = runs["jax"][path]
    for rank in runs["mesh"]:
        got = rank[path]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _assert_parity(g, w)


def test_synthesize_mel_and_warmups_on_the_model_axis(runs):
    """``synthesize_mel`` within 1e-5 of the peak of one process; the
    warmups run one process's shapes on every rank."""
    want = runs["want"]["mel_t0"]
    for rank in runs["mesh"]:
        for g, w in zip(rank["mel_t0"], want):
            assert g.shape == w.shape
            assert max_abs(g, w) <= SHAPE_LIMIT * float(np.abs(w).max())
        fused, batched = rank["warmup"]
        assert fused == 2 * len(runs["pairs"])
        assert batched == runs["batched_shapes"]


def test_bf16_on_the_model_axis_passes_jaxs_gate(runs):
    """A bf16 pipeline on the 2×2 mesh against the f32 one-process pipeline
    at temperature 0, under ``tests/test_torch_bf16.py``'s one-process
    gate (JAX's): equal frames, mel max|Δ| < 0.05 and mean < 0.01, audio
    max|Δ| < 1e-3, f32 out."""
    a32, m32 = runs["want"]["bf16_f32"]
    for rank in runs["mesh"]:
        a16, m16 = rank["bf16"]
        assert len(a16) == len(a32) and m16.shape == m32.shape
        d_mel = np.abs(m32 - m16)
        assert 0 < d_mel.max() < 0.05 and d_mel.mean() < 0.01
        assert np.abs(a32 - a16).max() < 1e-3
        assert a16.dtype == np.float32


def test_use_mesh_leaves_a_shared_model_whole(runs):
    for rank in runs["mesh"]:
        assert rank["shared_model_kept_whole"]


def test_production_hifigan_tensor_parallel(runs):
    """``HiFiGANConfig()`` (512 initial channels) with its wide convs split
    over the model axis and 8 mels of 24 frames over the data axis equals
    the one-process waveform (JAX's atol 3e-5, rtol 2e-5; after
    ``tests/test_parallel.py:162``)."""
    want = runs["want"]["hifigan"].numpy()
    assert np.abs(want).max() > 0
    for rank in runs["mesh"]:
        np.testing.assert_allclose(rank["hifigan"].numpy(), want, atol=3e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("t", R.VOCODE_LENGTHS)
def test_vocode_sharded_lanes_over_both_axes(runs, t):
    """Four windows, one a rank of the 2×2 mesh (a model group vocodes its
    two as one batch on the split vocoder, each rank keeping its own):
    the whole waveform on every rank within 1e-5 of the peak of
    ``vocode`` (after ``tests/test_parallel.py:238-244``)."""
    want = runs["want"][f"vocode_{t}"]
    for rank in runs["mesh"]:
        got = rank[f"vocode_{t}"]
        assert got.shape == want.shape == (t * 256,)
        assert max_abs(got, want) <= SHAPE_LIMIT * float(np.abs(want).max())
    for rank in runs["mesh"]:
        got16 = rank["vocode_pcm16"]
        assert got16.dtype == np.int16
        assert np.abs(got16.astype(np.int32) - runs["want"][
            "vocode_pcm16"].astype(np.int32)).max() <= 1


def _flat(params):
    if "gen" in params:
        return {f"{side}.{k}": v for side in ("gen", "disc")
                for k, v in params[side].items()}
    return params


def _grad_errs(got, want):
    """Per update: the largest leaf error as a share of the update's
    largest |g| (leaf by leaf over the same names; the error itself where
    every gradient is zero, as the small GAN generator's are once its
    first step saturates its tanh)."""
    out = []
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        peak = max(float(v.abs().max()) for v in w.values())
        err = max(max_abs(g[k], v) for k, v in w.items())
        out.append(err / peak if peak else err)
    return out


@pytest.mark.parametrize("case", ["duration", "vae", "postnet", "gan"])
def test_model_axis_steps_match_one_process(runs, case):
    """Three SGD steps (GAN: rounds, both states sharded) on the 2×2 mesh
    equal three in one process: every gradient leaf within 1e-5 of the
    update's largest |g|, params (and PostNet's statistics) within 2e-5,
    metrics within 1e-5 relative (after ``tests/test_parallel.py:306``).
    The same steps with the input-gradient sum planted out read above
    both limits."""
    single = runs["single"][case]
    for rank in runs["mesh"]:
        got = rank[case]
        assert max(_grad_errs(got["grads"], single["grads"])) <= GRAD_SHARE
        want_p, got_p = _flat(single["params"]), _flat(got["params"])
        for k, v in want_p.items():
            if v.is_floating_point():
                assert max_abs(got_p[k], v) <= PARAMS_ATOL, k
        for gm, wm in zip(got["metrics"], single["metrics"]):
            for k in wm:
                assert abs(gm[k] - wm[k]) <= 1e-5 * max(1.0, abs(wm[k])), k
        fault = rank[f"{case}_fault"]
        assert max(_grad_errs(fault["grads"], single["grads"])) > GRAD_SHARE
        fault_p = _flat(fault["params"])
        assert max(max_abs(fault_p[k], v) for k, v in want_p.items()
                   if v.is_floating_point()) > PARAMS_ATOL


def test_adam_moments_are_slices(runs):
    """Adam's moments of a sharded parameter have the slice's shape, half
    the whole parameter's output channels."""
    sd = runs["one_ckpt"]["params"]
    for rank in runs["mesh"]:
        moments = rank["adam_moments"]
        assert moments
        for key, (p, m, v) in moments.items():
            assert p == m == v
            assert np.prod(p) * 2 == sd[key].numel()


def test_model_axis_checkpoint_restores_in_one_process(runs):
    """The 2×2 ranks' checkpoint (rank 0 wrote whole tensors) is the state
    every rank reports, restores into a one-process state bitwise, and one
    more Adam step from it in one process matches the ranks' next step."""
    work, case = runs["work"], runs["cases"]["duration"]
    state = R.tp_state(case, adam=True)
    CheckpointManager(work / "ckpt_tp").restore(state)
    got = state.state_dict()
    for rank in runs["mesh"]:
        want = rank["ckpt_tp_state"]
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), k
        for idx, st in want["opt_state"]["state"].items():
            for name, v in st.items():
                assert torch.equal(got["opt_state"]["state"][idx][name], v)
    R.tp_adam_steps(state, case, 1)
    for rank in runs["mesh"]:
        for k, v in rank["ckpt_tp_next"].items():
            assert max_abs(state.params.state_dict()[k], v) <= PARAMS_ATOL, k


def test_one_process_checkpoint_restores_on_the_model_axis(runs):
    """A one-process checkpoint (params and Adam moments) restores into the
    2×2 ranks' sharded state: gathered back, it is the saved state,
    bitwise."""
    want = runs["one_ckpt"]
    for rank in runs["mesh"]:
        got = rank["ckpt_one_restored"]
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), k
        for idx, st in want["opt_state"]["state"].items():
            for name, v in st.items():
                assert torch.equal(got["opt_state"]["state"][idx][name], v)


def test_model_axis_collectives(runs):
    """The model axis took its gathers, input-gradient sums and the
    clipping norm's sum, all as all-reduces on gloo."""
    for rank in runs["mesh"]:
        calls = rank["collectives"]
        paths = {path for (path, _, _) in calls}
        assert {"tp_gather", "tp_input_grad", "grad_norm", "tp_state",
                "use_mesh", "vocode_sharded", "gradients"} <= paths
        assert {op for (_, op, _) in calls} <= {"all_reduce", "broadcast"}
        assert {b for (_, _, b) in calls} == {"gloo"}


# -- a stage driver with --model_parallel -------------------------------------


def _beside(fn, *args):
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised in join
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box.get("out")

    return join


def test_train_encoder_model_parallel_matches_one_process(tmp_path):
    """``train_encoder --mesh --model_parallel 2 --force_cpu_devices 2``
    (a 1×2 mesh: both ranks take the whole batch of 4 and split the wide
    layers) ends in the one-process run's checkpoint, whole tensors
    written by rank 0: the same steps, params within 1e-5, except where
    Adam turns a rounding-level gradient into a step of up to lr (the
    attention key biases, whose true gradient is zero), within 2 × the
    summed learning rates, as the data-axis driver test holds."""
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(SMALL_CFG))
    root, align = build_mini_corpus(tmp_path, n=12)
    argv = ["--config", str(cfg_file), "--data_root", str(root),
            "--alignment_dir", str(align), "--batch_size", "4",
            "--num_epochs", "2"]
    mesh = _beside(train_encoder.main, argv + [
        "--cache_dir", str(tmp_path / "cache2"), "--output_dir",
        str(tmp_path / "mesh"), "--mesh", "--model_parallel", "2",
        "--force_cpu_devices", "2"])
    train_encoder.main(argv + ["--cache_dir", str(tmp_path / "cache1"),
                               "--output_dir", str(tmp_path / "single"),
                               "--device", "cpu"])
    mesh()
    ck = {r: CheckpointManager(tmp_path / r / "encoder" / "checkpoints")
          for r in ("single", "mesh")}
    assert ck["mesh"].all_steps() == ck["single"].all_steps()
    want, got = ck["single"].restore_raw(), ck["mesh"].restore_raw()
    assert got["step"] == want["step"] > 0
    moved = 0
    for k, v in want["params"].items():
        assert got["params"][k].shape == v.shape, k
        if not v.is_floating_point():
            continue
        tol = 2e-2 if k.endswith("attention.key.bias") else 1e-5
        assert max_abs(got["params"][k], v) <= tol, k
        moved += 1
    assert moved
    for idx, st in want["opt_state"]["state"].items():
        for name, v in st.items():
            assert got["opt_state"]["state"][idx][name].shape == v.shape
