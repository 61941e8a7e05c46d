"""Data-parallel training of the port on two gloo ranks: each stage's mesh
steps against the same steps in one process, and the duration stage
against JAX's ``mesh_training_placement`` (after
``tests/test_parallel.py:246-303``).

One group of two ranks (``tests/torch_mesh_ranks.py``) runs every case;
the single-process references and the JAX steps run here meanwhile. SGD
keeps the updates linear in the gradients, so a rounding-level difference
in a gradient stays one in the params. The shards are chosen to differ:
ragged masks with other mask counts on each rank, and PostNet inputs whose
statistics differ between the ranks, so averaging per-rank means or taking
per-rank BatchNorm statistics would fail these checks.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iris_tts_tpu_torch.config import config_to_json
from iris_tts_tpu_torch.convert.from_jax import module_state_from_jax
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE
from iris_tts_tpu_torch.runtime import seeded_generator
from tests import torch_mesh_ranks as ranks_mod
from tests.torch_port_utils import max_abs, numpy_tree, port_config

torch.set_num_threads(2)

B, P, T = 8, 6, 16
LR = 1e-2
# Mesh steps against single-process steps: the gradients differ by the
# order of the cross-rank sums only (JAX's own mesh test holds 2e-6).
ATOL = 2e-6


def _jax_cfgs():
    from tests.test_gan import _CFG as gan_cfg
    from tests.test_train_steps import CFG

    nodrop = dataclasses.replace(
        CFG, encoder=dataclasses.replace(CFG.encoder, dropout=0.0),
        duration=dataclasses.replace(CFG.duration, dropout=0.0))
    return CFG, nodrop, gan_cfg


def _init(module, seed):
    init_params(module, seeded_generator(seed, "cpu"))
    return module.state_dict()


def _duration_batch(rng, rows=B, lengths=None):
    lengths = lengths if lengths is not None else rng.integers(2, P + 1, rows)
    mask = (np.arange(P)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    return {
        "phoneme_ids": (rng.integers(2, 12, (rows, P)) * mask).astype(
            np.int64),
        "durations": (rng.integers(1, 5, (rows, P)) * mask).astype(
            np.float32),
        "phoneme_mask": mask,
    }


def _vae_batch(rng, rows=4, shift_second_half=False):
    """Rows 0-1 (rank 0) carry 6 and 5 phonemes, rows 2-3 (rank 1) 2 and 3:
    the ranks' frame-mask counts differ."""
    b = _duration_batch(rng, rows, lengths=[6, 5, 2, 3])
    b["durations"] = b["durations"].clip(max=2.0)
    mel = rng.standard_normal((rows, T, 8)).astype(np.float32)
    if shift_second_half:  # other statistics on rank 1
        mel[rows // 2:] = 3.0 * mel[rows // 2:] + 1.0
    b["mel"] = mel
    return b


def _cases():
    cfg_j, nodrop_j, gan_j = _jax_cfgs()
    cfg, nodrop, gan = (port_config(c) for c in (cfg_j, nodrop_j, gan_j))
    rng = np.random.default_rng(0)
    enc_dur = torch.nn.ModuleDict({
        "encoder": PhonemeEncoder(cfg.encoder),
        "duration": DurationPredictor(cfg.encoder.embed_dim, cfg.duration)})
    dur_sd = _init(enc_dur, 1)
    enc_sd = {k[len("encoder."):]: v for k, v in dur_sd.items()
              if k.startswith("encoder.")}
    vae_sd = _init(TextConditionedVAE(cfg.vae), 2)
    vae_mod = TextConditionedVAE(cfg.vae)
    vae_mod.load_state_dict(vae_sd)
    cases = {
        # dropout on: the masks are the global batch's on every rank
        "duration": dict(stage="duration", config=config_to_json(cfg),
                         modules={"duration": dur_sd},
                         batches=[_duration_batch(rng) for _ in range(3)]),
        "vae": dict(stage="vae", config=config_to_json(cfg),
                    modules={"vae": vae_sd, "encoder": enc_sd},
                    batches=[_vae_batch(rng) for _ in range(3)],
                    kl_weight=0.5, clip=0.5),
        "postnet": dict(stage="postnet", config=config_to_json(cfg),
                        modules={"postnet": _init(PostNet(cfg.postnet), 3),
                                 "encoder": enc_sd, "vae": vae_sd},
                        batches=[_vae_batch(rng, shift_second_half=True)
                                 for _ in range(3)]),
        "accum": dict(stage="duration", config=config_to_json(nodrop),
                      modules={"duration": dur_sd}, accum_steps=2,
                      batches=[_duration_batch(rng)]),
    }
    gen_mod = HiFiGANGenerator(gan.hifigan)
    init_params(gen_mod, seeded_generator(4, "cpu"))
    with torch.no_grad():  # audible fake audio at this width
        for n, p in gen_mod.named_parameters():
            if n.endswith("weight"):
                p.mul_(8.0)
    hop = gan.hifigan.total_upsample
    cases["gan"] = dict(
        stage="gan", config=config_to_json(gan),
        modules={"gen": gen_mod.state_dict(),
                 "disc": _init(HiFiGANDiscriminators((2,), 1, 0.125), 5)},
        batches=[{"mel": rng.standard_normal(
                      (4, 8, gan.hifigan.in_channels)).astype(np.float32),
                  "audio": (0.3 * rng.standard_normal((4, 8 * hop))).astype(
                      np.float32)} for _ in range(3)])
    for case in cases.values():
        case.setdefault("lr", LR)
    return cases, nodrop_j


def _jax_duration_case(nodrop_j):
    """JAX's mesh steps (8 virtual devices) and the port case on its
    weights: dropout 0, three SGD steps on one batch of 8 rows."""
    from tests.test_train_steps import _duration_batch as jbatch
    from tests.test_train_steps import _init_duration_state

    sys.path.insert(0, str(ranks_mod.REPO))
    from scripts.common import mesh_training_placement as jplace

    from iris_tts_tpu.train import TrainState as JState
    from iris_tts_tpu.train.steps import make_duration_train_step as jmake

    key = jax.random.PRNGKey(11)
    base = _init_duration_state(key)
    b4 = jbatch(np.random.default_rng(11))
    batch = {k: jnp.concatenate([v, v]) for k, v in b4.items()}
    meshed, place = jplace(JState.create(base.params, optax.sgd(LR), key))
    placed = place(batch)
    assert len(placed["phoneme_ids"].sharding.device_set) == 8
    step = jax.jit(jmake(nodrop_j))
    for _ in range(3):
        meshed, jm = step(meshed, placed)
    case = dict(stage="duration", config=config_to_json(
        port_config(nodrop_j)), lr=LR,
        modules={"duration": module_state_from_jax(numpy_tree(base.params))},
        batches=[{k: np.asarray(v).astype(
            np.int64 if k == "phoneme_ids" else np.float32)
            for k, v in batch.items()}] * 3)
    return case, meshed, float(jm["duration_loss"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_train")
    cases, nodrop_j = _cases()
    jcase, jstate, jloss = _jax_duration_case(nodrop_j)
    cases["duration_jax"] = jcase
    torch.save(cases, work / "train_cases.pt")
    group = ranks_mod.start_ranks("train", work, 2, deadline_s=150)
    single = {name: ranks_mod.run_train_case(case)
              for name, case in cases.items()}
    full = dict(cases["accum"], accum_steps=1)  # the accumulated batch whole
    single["accum_full"] = ranks_mod.run_train_case(full)
    mesh = group.join()
    return {"cases": cases, "single": single, "mesh": mesh,
            "jax": (jstate, jloss)}


def _flat(params):
    if "gen" in params:
        return {f"{side}.{k}": v for side in ("gen", "disc")
                for k, v in params[side].items()}
    return params


def _assert_close(got, want, atol=ATOL):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    moved = 0
    for k, v in want.items():
        if v.is_floating_point():
            err = max_abs(got[k], v)
            assert err <= atol, (k, err)
            moved += 1
    assert moved


@pytest.mark.parametrize("case", ["duration", "vae", "postnet", "gan"])
def test_mesh_steps_match_single_process(runs, case):
    """Three SGD steps (GAN: rounds) on two ranks equal three in one
    process: params (and PostNet's running statistics), the same on both
    ranks, and the global step metrics."""
    want = runs["single"][case]
    for rank in runs["mesh"]:
        got = rank[case]
        _assert_close(got["params"], want["params"])
        for gm, wm in zip(got["metrics"], want["metrics"]):
            assert set(gm) == set(wm)
            for k in wm:
                assert abs(gm[k] - wm[k]) <= 1e-5 * max(1.0, abs(wm[k])), k
    # the steps moved the params
    init = runs["cases"][case]["modules"]
    first = next(iter(init.values()))
    after = _flat(want["params"])
    key = next(k for k in first if first[k].is_floating_point()
               and not k.endswith("running_var"))
    name = (f"gen.{key}" if case == "gan" else key)
    assert max_abs(after[name], first[key]) > 0


def test_postnet_statistics_are_global(runs):
    """PostNet's running statistics after the mesh steps are the global
    batch's, and the shards' statistics differed (a per-rank BatchNorm
    would have given rank 0 other running means than rank 1)."""
    want = runs["single"]["postnet"]["params"]
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for rank in runs["mesh"]:
        for k in stats:
            assert max_abs(rank["postnet"]["params"][k], want[k]) <= ATOL, k
    batch = runs["cases"]["postnet"]["batches"][0]["mel"]
    assert abs(batch[:2].mean() - batch[2:].mean()) > 0.5


def test_vae_shards_carry_different_mask_counts(runs):
    """The VAE case's ranks see other frame-mask counts (a per-rank masked
    mean would weight them wrongly), and the mesh step still matches."""
    b = runs["cases"]["vae"]["batches"][0]
    frames = (b["durations"] * b["phoneme_mask"]).sum(axis=1)
    assert frames[:2].sum() != frames[2:].sum()
    for rank in runs["mesh"]:
        _assert_close(rank["vae"]["params"], runs["single"]["vae"]["params"])


def test_accumulation_on_two_ranks(runs):
    """accum_steps=2 on two ranks (each microbatch spread over both)
    equals the one-process accumulated step and the whole-batch step
    (after ``tests/test_parallel.py:507``)."""
    for rank in runs["mesh"]:
        _assert_close(rank["accum"]["params"],
                      runs["single"]["accum"]["params"])
        _assert_close(rank["accum"]["params"],
                      runs["single"]["accum_full"]["params"])


def test_duration_mesh_steps_match_jax_mesh_steps(runs):
    """The port's mesh steps on JAX's weights against JAX's
    ``mesh_training_placement`` steps on 8 virtual devices (dropout 0)."""
    jstate, jloss = runs["jax"]
    want = module_state_from_jax(numpy_tree(jstate.params))
    for rank in runs["mesh"]:
        got = rank["duration_jax"]
        _assert_close(got["params"], want)
        assert abs(got["metrics"][-1]["duration_loss"] - jloss) <= (
            1e-5 * abs(jloss))


def test_gradients_reduced_with_one_flat_all_reduce_per_update(runs):
    """The gradients cross in one all-reduce per optimizer update (flat
    buffer), and nothing was staged through another route."""
    for rank in runs["mesh"]:
        calls = rank["collectives"]
        updates = sum(len(c["batches"]) * (2 if c["stage"] == "gan" else 1)
                      for c in runs["cases"].values())
        assert calls[("gradients", "all_reduce", "gloo")] == updates
        assert {op for (_, op, _) in calls} <= {"all_reduce", "broadcast"}
        assert calls[("batch_norm_stats", "all_reduce", "gloo")] > 0
