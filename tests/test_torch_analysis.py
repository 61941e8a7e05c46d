"""The port's speed-of-light, memory and vocoder-profile tools
(``iris_tts_tpu_torch.scripts.{roofline,mem_analysis,profile_vocoder}``),
run in-process with ``--device cpu``: the roofline's FLOP and byte counts
against XLA's ``cost_analysis()`` of the JAX package's functions at the
same full-width shapes, the JAX tools' command-line tests mirrored, their
options against the JAX scripts', the memory tracker's arithmetic, and the
vocoder profile's stages against the generator."""

import argparse
import importlib
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iris_tts_tpu.config as jcfg
from iris_tts_tpu.models import DurationPredictor as JDuration
from iris_tts_tpu.models import PhonemeEncoder as JEncoder
from iris_tts_tpu.models import PostNet as JPostNet
from iris_tts_tpu.models import TextConditionedVAE as JVAE
from iris_tts_tpu.models.hifigan import HiFiGANGenerator as JGenerator
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.text.phonemes import PhonemeVocab as JVocab
from iris_tts_tpu_torch import HiFiGANConfig, IrisConfig
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.runtime import seeded_generator
from iris_tts_tpu_torch.scripts import mem_analysis, profile_vocoder, roofline
from scripts.roofline import _cost as xla_cost

torch.set_num_threads(2)

TOOLS = {"roofline": roofline, "mem_analysis": mem_analysis,
         "profile_vocoder": profile_vocoder}
T2M = "text_to_mel (enc+dur+VAE+PostNet)"
VOC = "vocoder (HiFiGAN)"
E2E = "fused end-to-end"


def _jax_pipeline_shapes() -> JPipeline:
    """JAX's full-width pipeline with parameter shapes only (what
    ``TTSPipeline.initialize`` builds, through ``jax.eval_shape``): XLA's
    cost model reads shapes, and nothing is compiled but the function
    analysed."""
    vocab = JVocab.default_arpabet()
    cfg = jcfg.IrisConfig()
    cfg = replace(cfg, encoder=replace(cfg.encoder, vocab_size=len(vocab)))
    key = jax.random.PRNGKey(0)
    t = cfg.vae.down_factor * 4
    ids = jnp.zeros((1, 8), jnp.int32)
    p_enc = jax.eval_shape(JEncoder(config=cfg.encoder).init, key, ids)
    enc_out = jax.ShapeDtypeStruct((1, 8, cfg.encoder.embed_dim),
                                   jnp.float32)
    params = {
        "encoder": p_enc["params"],
        "duration": jax.eval_shape(JDuration(config=cfg.duration).init, key,
                                   enc_out)["params"],
        "vae": jax.eval_shape(
            JVAE(config=cfg.vae).init, {"params": key, "sample": key},
            jnp.zeros((1, t, cfg.vae.n_mels)),
            jnp.zeros((1, t, cfg.vae.cond_dim)))["params"],
        "postnet": jax.eval_shape(JPostNet(config=cfg.postnet).init, key,
                                  jnp.zeros((1, t, cfg.postnet.n_mels))),
        "hifigan": jax.eval_shape(JGenerator(config=cfg.hifigan).init, key,
                                  jnp.zeros((1, 8, cfg.hifigan.in_channels))
                                  )["params"],
    }
    return JPipeline(config=cfg, params=params, vocab=vocab,
                     text_processor=None)


@pytest.fixture(scope="module")
def vocoder_costs():
    """(port, XLA) (FLOPs, bytes) of the full-width generator at B=1,
    T=32 frames."""
    mel = np.zeros((1, 32, 80), np.float32)
    gen = HiFiGANGenerator(HiFiGANConfig())
    port = roofline.count_cost(gen, torch.from_numpy(mel))
    jgen = JGenerator(config=jcfg.HiFiGANConfig())
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), mel)
    xla = xla_cost(lambda p, m: jgen.apply(p, m), shapes, jnp.asarray(mel))
    return port, xla


def test_vocoder_flops_match_xla(vocoder_costs):
    """FlopCounterMode over the port's generator against XLA's count of
    JAX's generator (measured: 19.651 against 19.628 GFLOP, 0.12%)."""
    (flops, _), (xla_flops, _) = vocoder_costs
    assert abs(flops / xla_flops - 1) <= 0.01, (flops, xla_flops)


def test_vocoder_bytes_within_the_measured_band(vocoder_costs):
    """The eager byte count reads above XLA's, which is taken after
    fusion (measured: 0.4344 against 0.4011 GB, +8.3%); it must stay an
    upper bound, and near that gap."""
    (_, nbytes), (_, xla_bytes) = vocoder_costs
    assert 1.06 <= nbytes / xla_bytes <= 1.11, (nbytes, xla_bytes)


def test_text_to_mel_flops_match_xla():
    """The port's fused text→mel count against XLA's count of JAX's
    ``_fused_mel_fn`` at B=1, P=32, T=128 (JAX's roofline test shape).
    Measured: 578.93 against 559.91 MFLOP, the port 3.4% above. The two
    counters differ in two ways: XLA counts a padded convolution's taps
    over real input only, FlopCounterMode every tap (at 32 phonemes and
    128 frames a kernel's padded edge is a few percent of its taps), and
    XLA also counts elementwise work, which pulls the other way."""
    B, P, T = 1, 32, 128
    jp = _jax_pipeline_shapes()
    xla_flops, _ = xla_cost(
        jp._fused_mel_fn, jp.params, jnp.zeros((B, P), jnp.int32),
        jnp.full((B,), P, jnp.int32), jnp.asarray(0, jnp.int32),
        total_frames=T, use_postnet=True, upsample="hard")
    pipe = TTSPipeline.initialize(IrisConfig(), seed=0, device="cpu")
    fn = roofline.stage_fns(pipe, B, P, T)[T2M]
    flops, nbytes = roofline.count_cost(fn)
    assert nbytes > 0
    assert 1.02 <= flops / xla_flops <= 1.05, (flops, xla_flops)


def test_roofline_cli_json(capsys):
    """``scripts/roofline.py``'s CLI test (``tests/test_scripts.py``):
    sane JSON, with JAX's keys, and the end-to-end stage at least the
    vocoder's and text_to_mel's FLOPs together."""
    report = roofline.main(["--batch", "1", "--frames", "128", "--phonemes",
                            "32", "--json", "--device", "cpu"])
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert data == json.loads(json.dumps(report))
    assert set(data) == {"config", "audio_s_per_dispatch", "peak_tflops",
                         "peak_hbm_gbps", "stages"}
    assert data["config"] == {"B": 1, "T": 128, "P": 32,
                              "dtype": "bfloat16"}
    assert data["peak_tflops"] == 989.0 and data["peak_hbm_gbps"] == 3350.0
    stages = {s["stage"]: s for s in data["stages"]}
    assert list(stages) == [T2M, VOC, E2E]
    voc, e2e, t2m = stages[VOC], stages[E2E], stages[T2M]
    assert voc["gflops"] > 0 and voc["gbytes"] > 0
    assert e2e["gflops"] >= voc["gflops"]
    assert voc["bound"] in ("HBM", "FLOPs")
    assert 0 < e2e["sol_rt_factor"] < 1e7
    assert e2e["gflops"] >= (voc["gflops"] + t2m["gflops"]) * (1 - 1e-12)
    row = set(voc)
    assert row == {"stage", "gflops", "gbytes", "arith_intensity",
                   "t_flops_ms", "t_hbm_ms", "bound", "sol_rt_factor"}


def test_roofline_peaks_follow_the_dtype():
    args = roofline.build_parser().parse_args(["--dtype", "float32"])
    assert args.peak_tflops is None  # resolved from the dtype
    assert roofline.PEAK_TFLOPS == {"bfloat16": 989.0, "float32": 66.9}
    rows = roofline.roofline_rows({"s": (66.9e9, 3.35e9)}, 1.0, 66.9, 3350)
    assert rows[0]["t_flops_ms"] == pytest.approx(1.0)
    assert rows[0]["t_hbm_ms"] == pytest.approx(1.0)
    assert rows[0]["sol_rt_factor"] == pytest.approx(1000.0)


def test_byte_counter_skips_views_and_counts_inputs_and_outputs():
    a = torch.ones(100)  # 400 bytes
    counter = roofline.ByteCounter()
    with counter:
        b = a.view(10, 10).t()  # views: nothing
        c = b.detach()
        d = c.t() * 2  # 400 in, 400 out
        d.add_(1)  # 400 read, 400 written (the same tensor, counted twice)
    assert counter.by_op == {"mul": 800, "add_": 800}
    assert counter.total == 1600


# ---------------------------------------------------------------------------
# mem_analysis
# ---------------------------------------------------------------------------


def test_live_bytes_tracks_allocations_and_frees():
    tracker = mem_analysis.LiveBytes()
    a = torch.zeros(1000)
    with tracker:
        b = a + 1  # 4000 new bytes
        c = b * 2  # 8000 live
        b.mul_(3)  # in place: nothing new
        v = c.view(10, 100)  # a view: nothing new
        del b  # 4000 live
        d = torch.ones(500)  # 6000 live
    assert tracker.peak == 8000
    assert tracker.live == 6000
    del c, v
    assert tracker.live == 2000
    del d
    assert tracker.live == 0


def test_storage_bytes_walks_a_train_state_once_a_storage():
    from iris_tts_tpu_torch.train.state import TrainState, adam_clipped

    lin = torch.nn.Linear(4, 3)
    st = TrainState.create(lin, adam_clipped(1e-3), 0)
    got = mem_analysis.storage_bytes((st, {"x": lin.weight}),
                                     torch.device("cpu"))
    assert sum(got.values()) == 4 * (12 + 3)
    lin(torch.ones(2, 4)).sum().backward()
    st.apply_gradients()  # Adam moments: two more copies of the params
    got = mem_analysis.storage_bytes(st, torch.device("cpu"))
    steps = 4 * 2  # Adam's f32 step counters, one a parameter
    assert sum(got.values()) == 3 * 4 * (12 + 3) + steps


def test_mem_analysis_cli_json(capsys):
    """``scripts/mem_analysis.py``'s CLI test (``tests/test_scripts.py``):
    one JSON row a remat variant, positive temp bytes."""
    mem_analysis.main(["--stage", "vae", "--batch_size", "2", "--frames",
                       "64", "--phonemes", "8", "--device", "cpu"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip()
            .splitlines()]
    assert {row["remat"] for row in rows} == {False, True}
    assert all(row["temp_mib"] > 0 for row in rows)
    assert all(row["stage"] == "vae" and row["B"] == 2 and row["T"] == 64
               and row["dtype"] == "f32" for row in rows)
    # the state is updated in place: it is both what the step reads and
    # what it returns (the batch aside)
    assert all(0 < r["out_mib"] <= r["args_mib"] for r in rows)


def test_mem_analysis_gan_rows(capsys):
    rows = mem_analysis.main(["--stage", "gan", "--batch_size", "1",
                              "--frames", "8", "--device", "cpu"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.strip()
               .splitlines()]
    assert printed == rows
    assert [(r["stage"], r["remat"]) for r in rows] == [
        ("gan_gen", False), ("gan_disc", False), ("gan_gen", True)]
    assert all(r["temp_mib"] > 0 and r["args_mib"] > 0 for r in rows)
    # both states with their Adam moments, before every row
    assert len({r["args_mib"] for r in rows}) == 1


def test_allocator_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        mem_analysis.measure_step(lambda: None, (), torch.device("cpu"),
                                  "allocator")


# ---------------------------------------------------------------------------
# profile_vocoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocoder_stages_chain_to_the_generator_bitwise(dtype):
    gen = HiFiGANGenerator(HiFiGANConfig(), dtype=dtype)
    init_params(gen, seeded_generator(0, "cpu"))
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 9, 80)).astype(np.float32)).to(dtype)
    calls = profile_vocoder.stage_calls(gen)
    n = len(HiFiGANConfig().upsample_rates)
    assert [c for c, _ in calls] == (
        ["conv_pre"] + [f"{p}_{i}" for i in range(n) for p in ("ups", "mrf")]
        + ["conv_post"])
    with torch.no_grad():
        x = mel
        for _, call in calls:
            x = call(x)
        want = gen(mel)
    assert x.dtype == want.dtype and torch.equal(x, want)


def test_profile_vocoder_cli_prints_every_stage(capsys):
    out = profile_vocoder.main(["--device", "cpu", "--dtype", "f32",
                                "--seconds", "0.2"])
    lines = capsys.readouterr().out.splitlines()
    n = len(HiFiGANConfig().upsample_rates)
    assert lines[0].startswith("full generator:") and "B=1, f32" in lines[0]
    assert lines[1].lstrip().startswith("conv_pre  [     17 x  80]")
    for i in range(n):
        assert lines[2 + i].lstrip().startswith(f"stage {i}: ups [")
        assert "MRF:" in lines[2 + i]
    assert lines[2 + n].lstrip().startswith("conv_post [")
    assert lines[3 + n].startswith("sum of the parts:")
    assert len(lines) == 4 + n
    assert set(out["parts_ms"]) == {c for c, _ in profile_vocoder.stage_calls(
        HiFiGANGenerator(HiFiGANConfig()))}
    assert out["sum_ms"] == pytest.approx(sum(out["parts_ms"].values()))
    assert all(v > 0 for v in out["parts_ms"].values())


def test_avg_ms_cycles_the_inputs():
    from iris_tts_tpu_torch.scripts.common import avg_ms

    seen = []
    ms = avg_ms(lambda x: seen.append(x) or torch.zeros(1), [1, (2,)], n=5)
    assert seen == [1, 1, 2, 1, 2, 1] and ms >= 0


# ---------------------------------------------------------------------------
# the tools' options and their device
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _jax_options(name, monkeypatch) -> set:
    """The option strings of the JAX script ``scripts/<name>.py``: its
    ``main()`` runs up to ``parse_args``, which hands over the parser."""
    mod = importlib.import_module(f"scripts.{name}")
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        mod.main()
    monkeypatch.undo()
    return {s for a in seen["parser"]._actions for s in a.option_strings}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_options_are_jaxs_plus_device(name, monkeypatch):
    ours = {s for a in TOOLS[name].build_parser()._actions
            for s in a.option_strings}
    assert ours == _jax_options(name, monkeypatch) | {"--device"}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_cuda_raises(name, monkeypatch, capsys):
    """No CUDA and no ``--device``: the tool stops with resolve_device's
    error before it builds or prints anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[name].main([])
    assert capsys.readouterr().out == ""
