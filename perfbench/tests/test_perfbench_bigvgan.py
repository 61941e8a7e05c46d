"""A whole run of a BigVGAN cell at a tiny size on the CPU, with the look
for a card skipped: sound, it comes out correct; with α and β swapped in
the program's activations, it comes out not correct by ``wave_gap``. Off
the card a traced run reads no device metric. The weights are the seed's,
and the reference agrees with the port's generator on them."""

import json
import time
from pathlib import Path

import torch

from perfbench import run
from perfbench.drivers import bulk_synthesize_bigvgan as driver

TINY = Path(__file__).resolve().parent / "tiny"
SEED = 2**31 + 1193
CELL = "tiny-bulk-bigvgan"


def _tiny_bench():
    bench = run.benchmark()
    bench["workloads"] = [{"name": CELL, "config": "tiny-bigvgan",
                           "traffic": CELL, "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = [CELL]
    return bench


def _run(trace=False):
    return run.run_cell(_tiny_bench(), CELL, SEED, 0.2, trace,
                        torch.device("cpu"), time.perf_counter(), base=TINY)


def test_sound_run_is_correct():
    result = _run()["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 8 and result["failed"] == 0
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}


def test_traced_run_reads_no_device_metric_off_the_card():
    result = _run(trace=True)["result"]
    assert result["correct"]
    assert not {"bigvgan_ms_per_batch", "bigvgan_roofline",
                "amp_act_ms_per_batch", "amp_act_roofline",
                "bigvgan_mfu_pct"} & set(result["metrics"])


def test_alpha_and_beta_swapped_are_caught(monkeypatch):
    from iris_tts_tpu_torch.ops import amp_cuda

    plain = amp_cuda.amp_plain
    monkeypatch.setattr(
        "iris_tts_tpu_torch.models.bigvgan.amp_plain",
        lambda x, alpha, beta, h: plain(x, beta, alpha, h))
    result = _run()["result"]
    assert not result["correct"]
    assert result["checks"]["wave_gap"]["value"] > \
        result["checks"]["wave_gap"]["limit"]


def test_weights_are_the_seeds_and_fit_both_models():
    cfg = run.cell_parts(_tiny_bench(), CELL, TINY)["config"]
    a = driver.draw_bigvgan(cfg["model"]["hifigan"], SEED, torch.device("cpu"))
    b = driver.draw_bigvgan(cfg["model"]["hifigan"], SEED, torch.device("cpu"))
    c = driver.draw_bigvgan(cfg["model"]["hifigan"], SEED + 1,
                            torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_pre.weight"], c["conv_pre.weight"])
    alpha = a["resblocks.0.activations.0.act.alpha"]
    assert 0.3 < float(alpha.std()) < 0.7  # drawn, not BigVGAN's zeros
    from iris_tts_tpu_torch.config import config_from_json
    from iris_tts_tpu_torch.models.bigvgan import BigVGANGenerator

    gen = BigVGANGenerator(config_from_json(json.dumps(cfg["model"])).hifigan)
    gen.load_state_dict(a, strict=True)
