"""BigVGAN-v2 in the port, on the CPU: the generator and its anti-aliased
activation against the benchmark's plain reference
(``perfbench/reference/bigvgan.py``), the filter against its formula, a
torch emulation of the CUDA kernel's index arithmetic, the config's JSON,
the streaming radius, the checkpoint loader, the operator's cost, the
pipeline's entry points and the faults the benchmark's check must catch.
On a card (``cuda`` marker): the kernel against the composition at the
main path's shapes. The one test that reads the JAX package imports it
inside the test, so on a host without JAX the card tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_bigvgan.py``."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iris_tts_tpu_torch import config as tcfg
from iris_tts_tpu_torch.config import HiFiGANConfig, IrisConfig
from iris_tts_tpu_torch.models import bigvgan as tb
from iris_tts_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    receptive_radius_frames,
)
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.ops import amp_cuda as ac
from iris_tts_tpu_torch.utils import prof
from perfbench.check_bigvgan import wave_gap
from perfbench.reference import bigvgan as rb

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = HiFiGANConfig(
    upsample_rates=(4, 4, 2, 2, 2, 2),
    upsample_kernel_sizes=(8, 8, 4, 4, 4, 4),
    upsample_initial_channel=1536, activation="snakebeta")
TINY = dataclasses.replace(
    PUBLISHED, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
    upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
    resblock_dilations=((1, 3), (1, 3)))
# hop 256 as the pipeline's audio config, at a small width.
TINY_256 = dataclasses.replace(
    PUBLISHED, upsample_rates=(4, 4, 4, 4), upsample_kernel_sizes=(8, 8, 8, 8),
    upsample_initial_channel=32, resblock_kernel_sizes=(3,),
    resblock_dilations=((1, 3),))
WAVE_LIMIT = json.loads(
    (ROOT / "perfbench/limits/bigvgan-bulk-ljspeech.json").read_text()
)["wave_gap"]


def seeded(cfg: HiFiGANConfig, seed: int = 0, gain: float = 5.0):
    """The port's generator with seeded weights (convs × ``gain`` so the
    waveform is order one at a small width) and drawn log-α/β, and the
    reference on the same state dict."""
    gen = tb.BigVGANGenerator(cfg)
    init_params(gen, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("weight"):
                p.mul_(gain)
    ref = rb.BigVGAN(dataclasses.asdict(cfg))
    sd = dict(ref.state_dict())
    sd.update(gen.state_dict())
    ref.load_state_dict(sd, strict=True)
    return gen.eval(), ref.eval()


def mel(t: int, b: int = 2, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, 80, generator=g) * 2.0 - 3.0


def rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    peak = float(want.abs().max())
    assert peak > 0.05, peak  # a real signal is compared
    return float((got - want).abs().max()) / peak


def act_params(c: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=g) * 0.5,
            torch.randn(c, generator=g) * 0.5)


def ref_activation(c: int, alpha, beta):
    act = rb.Activation1d(rb.SnakeBeta(c))
    with torch.no_grad():
        act.act.alpha.copy_(alpha)
        act.act.beta.copy_(beta)
    return act


def kernel_emulation(x, alpha, beta, h, tile: int = 8):
    """The CUDA kernel's plan in torch (``amp_activation.cu``), per tile of
    ``tile`` outputs at n0: x staged from n0 − 6 by clamped indices; the
    activated pair v(2p), v(2p + 1) at p = n0 − 3 + j from xs[j … j + 6];
    Down's taps in the order k = 0 … 11, from the pairs directly for a
    group of 4 outputs inside the row, at the clamped index for a group
    within 3 outputs of either end."""
    b, c, t = x.shape
    a = torch.exp(alpha)[None, :]
    inv = 1.0 / (torch.exp(beta) + 1e-9)[None, :]
    out = torch.empty_like(x)

    def snake(u):
        return u + inv * torch.sin(a * u) ** 2

    for n0 in range(0, t, tile):
        n_out = min(tile, t - n0)
        xs = x[..., [min(max(n0 - 6 + j, 0), t - 1)
                     for j in range(tile + 16)]]
        ve, vo = [], []
        for j in range(tile + 8):
            ue = sum(h[2 * i + 1] * xs[..., j + 5 - i] for i in range(6))
            uo = sum(h[2 * i] * xs[..., j + 6 - i] for i in range(6))
            ve.append(snake(2.0 * ue))
            vo.append(snake(2.0 * uo))
        for q in range(n_out):
            q0 = q - q % 4  # the thread's group of 4 outputs
            inner = n0 + q0 >= 3 and n0 + q0 + 7 <= t
            acc = 0.0
            for k in range(12):
                m = 2 * (n0 + q) - 5 + k
                if not inner:
                    m = min(max(m, 0), 2 * t - 1)
                j = (m >> 1) - n0 + 3
                acc = acc + h[k] * (vo if m & 1 else ve)[j]
            out[..., n0 + q] = acc
    return out


# -- the filter and the activation -------------------------------------------


def test_filter_taps_match_the_published_formula():
    h = ac.kaiser_sinc_filter()
    assert h.shape == (12,) and h.dtype == torch.float32
    assert abs(float(h.sum()) - 1.0) < 1e-6
    assert torch.equal(h, h.flip(0))
    # Kaiser's rule: A = 2.285 (6 − 1) π (4 · 0.3) + 7.95 ≈ 51.02 → β ≈ 4.664
    a = 2.285 * 5 * np.pi * 1.2 + 7.95
    beta = 0.1102 * (a - 8.7)
    assert abs(beta - 4.664) < 1e-3
    t = np.arange(-6, 6) + 0.5
    want = np.kaiser(12, beta) * 0.5 * np.sinc(0.5 * t)
    np.testing.assert_allclose(h.numpy(), want / want.sum(), atol=1e-7)
    assert torch.equal(h, rb.kaiser_sinc_filter1d(0.25, 0.3, 12).reshape(-1))


@pytest.mark.parametrize("t", list(range(1, 17)) + [37])
def test_activation_matches_the_reference_and_the_kernel_plan(t):
    """The port's composition equals BigVGAN's ``Activation1d``; the
    kernel's plan (tiles of 8, so first, inner and last tiles and halos
    that cover the whole row) equals both, with both replicate paddings, at
    T = 1…16 and an odd T."""
    c = 3
    alpha, beta = act_params(c, t)
    x = torch.randn(2, c, t, generator=torch.Generator().manual_seed(t)) * 3
    with torch.no_grad():
        want = ref_activation(c, alpha, beta)(x)
    h = ac.kaiser_sinc_filter()
    got = ac.amp_plain(x, alpha, beta, h)
    assert got.shape == (2, c, t)
    assert float((got - want).abs().max()) <= 1e-6
    emu = kernel_emulation(x, alpha, beta, h)
    assert float((emu - want).abs().max()) <= 1e-5


# -- the generator ------------------------------------------------------------


def test_generator_matches_the_reference():
    gen, ref = seeded(TINY)
    m = mel(23)
    with torch.no_grad():
        got, want = gen(m), ref(m)
    assert got.shape == want.shape == (2, 23 * 4)
    assert rel(got, want) <= 1e-5


def test_published_widths_parameter_count_on_meta():
    with torch.device("meta"):
        gen = tb.BigVGANGenerator(PUBLISHED)
        ref = rb.BigVGAN(dataclasses.asdict(PUBLISHED))
    n = sum(p.numel() for p in gen.parameters())
    assert n == sum(p.numel() for p in ref.parameters()) == 112_199_472
    assert set(gen.state_dict()) == {k for k, _ in ref.named_parameters()}
    acts = [m for m in gen.modules() if isinstance(m, tb.Activation1d)]
    assert len(acts) == 109
    assert gen.conv_post.bias is None


def test_generators_refuse_the_other_config():
    with pytest.raises(ValueError, match="BigVGAN"):
        HiFiGANGenerator(TINY)
    with pytest.raises(ValueError, match="snakebeta"):
        tb.BigVGANGenerator(HiFiGANConfig())
    with pytest.raises(ValueError, match="remat"):
        tb.BigVGANGenerator(TINY, remat=True)
    assert tb.generator_class(TINY) is tb.BigVGANGenerator
    assert tb.generator_class(HiFiGANConfig()) is HiFiGANGenerator


def test_spans_and_counters_while_tracing():
    gen, _ = seeded(TINY)
    before = prof.counters()
    with torch.no_grad(), torch.profiler.profile() as p:
        gen(mel(9, b=1))
    got = prof.counters()
    assert got.get("vocoder.amp_library", 0) - before.get(
        "vocoder.amp_library", 0) == 2 * 2 * 2 * 2 + 1
    assert got.get("vocoder.amp_fused", 0) == before.get("vocoder.amp_fused",
                                                         0)
    names = [e.name for e in p.events()]
    assert names.count("iris.amp_act") == 17


# -- the config ---------------------------------------------------------------


def test_hifigan_config_json_unchanged_and_read_by_jax():
    """V1 and V2 configs serialise byte for byte as the JAX package writes
    them (the port's format before BigVGAN's key), and JAX reads a
    port-written V1 config; a BigVGAN config round-trips with its key."""
    import iris_tts_tpu.config as jcfg

    v2 = dict(hifigan=HiFiGANConfig(upsample_initial_channel=128))
    for port, jax in ((IrisConfig(), jcfg.IrisConfig()),
                      (IrisConfig(**v2), jcfg.IrisConfig(
                          hifigan=jcfg.HiFiGANConfig(
                              upsample_initial_channel=128)))):
        text = tcfg.config_to_json(port)
        assert text == jcfg.config_to_json(jax)
        assert jcfg.config_from_json(text) == jax
    big = IrisConfig(hifigan=PUBLISHED)
    text = tcfg.config_to_json(big)
    section = json.loads(text)["hifigan"]
    assert section["activation"] == "snakebeta"
    assert set(section) == {f.name for f in dataclasses.fields(
        HiFiGANConfig)}
    assert tcfg.config_from_json(text) == big
    bench = json.loads((ROOT / "perfbench/configs/"
                        "iris-ljspeech-bigvgan-v2.json").read_text())
    assert tcfg.config_from_json(json.dumps(bench["model"])).hifigan == \
        PUBLISHED


# -- streaming ----------------------------------------------------------------


def test_receptive_radius_counts_the_activations():
    assert receptive_radius_frames(HiFiGANConfig()) == 15
    plain = dataclasses.replace(PUBLISHED, activation="leaky_relu")
    assert receptive_radius_frames(PUBLISHED) > receptive_radius_frames(plain)
    # conv_pre 3 + Σ stages (⌈k/u⌉ + mrf) at their rates + post 5 + 3
    mrf = sum((11 - 1) // 2 * d + 5 + 10 for d in (1, 3, 5))
    r, spu = 3 * 256, 256
    for u, k in zip(PUBLISHED.upsample_rates,
                    PUBLISHED.upsample_kernel_sizes):
        r += -(-k // u) * spu
        spu //= u
        r += mrf * spu
    assert receptive_radius_frames(PUBLISHED) == -(-(r + 8) // 256)


@pytest.fixture(scope="module")
def pipe():
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline

    cfg = IrisConfig(
        encoder=tcfg.EncoderConfig(embed_dim=32, num_blocks=2, num_heads=2),
        duration=tcfg.DurationConfig(hidden_dim=16, num_layers=2),
        vae=tcfg.VAEConfig(cond_dim=32, model_channels=16, latent_dim=4,
                           num_wavenet_blocks=2, decoder_blocks=1,
                           flow_layers=2, flow_hidden=8),
        postnet=tcfg.PostNetConfig(num_layers=3, channels=8),
        hifigan=TINY_256)
    p = TTSPipeline.initialize(cfg, seed=3, device="cpu")
    with torch.no_grad():
        for name, w in p.model.hifigan.named_parameters():
            if name.endswith("weight"):
                w.mul_(9.0)
    return p


def test_vocode_streaming_equals_vocode(pipe):
    radius = receptive_radius_frames(pipe.config.hifigan)
    m = mel(2 * radius + 16 + 5, b=1, seed=4)[0].numpy()
    whole = pipe.vocode(m)
    chunks = list(pipe.vocode_streaming(m, chunk_frames=16))
    assert len(chunks) > 1
    assert rel(np.concatenate(chunks), whole) <= 1e-6


def test_pipeline_synthesizes_through_bigvgan(pipe):
    audio = pipe.synthesize("the quick brown fox.")
    assert audio.ndim == 1 and len(audio) % 256 == 0 and len(audio) > 0
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0


def test_from_jax_params_takes_a_vocoder_state_dict(pipe):
    """The acoustic model from a JAX-layout tree (drawn by the benchmark's
    weights module) and the vocoder from its own state dict."""
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from perfbench.weights import seeded_modules

    cfg = {"weights": {"seeded": ["encoder", "duration", "vae", "postnet"]},
           "model": json.loads(tcfg.config_to_json(pipe.config))}
    tree = seeded_modules(cfg, 5, torch.device("cpu"))
    vsd = pipe.model.hifigan.state_dict()
    built = TTSPipeline.from_jax_params(tree, pipe.config, device="cpu",
                                        vocoder_state_dict=vsd)
    for k, v in vsd.items():
        assert torch.equal(built.model.hifigan.state_dict()[k], v), k
    audio = built.synthesize("a fox.")
    assert len(audio) % 256 == 0 and np.isfinite(audio).all()
    with pytest.raises(ValueError, match="not both"):
        TTSPipeline.from_jax_params({**tree, "hifigan": {}}, pipe.config,
                                    device="cpu", vocoder_state_dict=vsd)


def test_tensor_parallel_sharding_refuses_bigvgan(pipe, monkeypatch):
    from iris_tts_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "replicate_params", lambda p, mesh: p)
    monkeypatch.setattr(sharding, "model_axis", lambda mesh: object())
    with pytest.raises(ValueError, match="tensor-parallel"):
        sharding.tp_param_sharding(pipe.model, None)


# -- the checkpoint layout ----------------------------------------------------


def test_loader_folds_weight_norm_and_checks_the_filters(tmp_path):
    from iris_tts_tpu_torch.convert.bigvgan import load_bigvgan

    _, ref = seeded(TINY, seed=5)
    for m in ref.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(m)
    sd = ref.state_dict()
    assert any(k.endswith("weight_g") for k in sd)
    assert any(k.endswith("lowpass.filter") for k in sd)
    path = tmp_path / "bigvgan_generator.pt"
    torch.save({"generator": sd}, path)
    gen = tb.BigVGANGenerator(TINY)
    gen.load_state_dict(load_bigvgan(path, TINY), strict=True)
    m = mel(17, seed=6)
    with torch.no_grad():
        assert rel(gen.eval()(m), ref.eval()(m)) <= 1e-5
    bad = dict(sd)
    key = next(k for k in bad if k.endswith("upsample.filter"))
    bad[key] = bad[key] * 1.01
    torch.save(bad, path)
    with pytest.raises(ValueError, match="Kaiser"):
        load_bigvgan(path, TINY)


# -- the operator's cost ------------------------------------------------------


def test_operator_counts_its_formula_on_meta():
    """FlopCounterMode and the roofline's ByteCounter count the operator
    by its formula, and the generator through it (on meta tensors, as on
    the card) differs from the CPU's composition only by the
    composition's padded edges (Up's conv runs over T + 10 inputs:
    240 · B · C FLOPs an activation)."""
    from iris_tts_tpu_torch.scripts import roofline

    x = torch.zeros(2, 5, 37, device="meta")
    a = torch.zeros(5, device="meta")
    got = roofline.count_cost(ac.amp_cuda, x, a, a)
    assert got == (48 * 2 * 5 * 37, 4 * (2 * 2 * 5 * 37 + 2 * 5))

    gen, _ = seeded(TINY)
    m = mel(8, b=1)
    want = roofline.count_cost(gen, m)
    fused = roofline.count_cost(gen.to("meta"), m.to("meta"))
    shapes = [(1, 16, 16)] * 8 + [(1, 8, 32)] * 9
    assert fused[0] == want[0] - sum(240 * c for _, c, _ in shapes)
    plain = sum(roofline.count_cost(
        ac.amp_plain, torch.zeros(s), torch.zeros(s[1]), torch.zeros(s[1]),
        ac.FILTER)[1] for s in shapes)
    assert fused[1] == want[1] - plain + sum(ac.amp_cost(s)[1]
                                             for s in shapes)


# -- the faults the benchmark's check must catch ------------------------------


def _zero_padded(x, alpha, beta, h):
    """The composition with zero padding where BigVGAN replicates."""
    c = x.shape[1]
    w = h.expand(c, 1, 12)
    u = F.conv_transpose1d(F.pad(x, (5, 5)), w, stride=2, groups=c)
    v = ac.snake_beta(2 * u[..., 15:-15], alpha, beta)
    return F.conv1d(F.pad(v, (5, 6)), w, stride=2, groups=c)


def _bf16_sine(x, alpha, beta):
    """SnakeBeta with its sine computed in bfloat16."""
    a, b = torch.exp(alpha[None, :, None]), torch.exp(beta[None, :, None])
    return x + (1.0 / (b + 1e-9)) * torch.sin((x * a).bfloat16()).float() ** 2


FAULTS = {
    "alpha-beta-swapped": (ac, "snake_beta", lambda x, a, b:
                           ac.SNAKE(x, b, a)),
    "zero-padding": (tb, "amp_plain", _zero_padded),
    "bf16-sine": (ac, "snake_beta", _bf16_sine),
}


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_the_check_catches_faults(fault, monkeypatch):
    """``check_bigvgan.wave_gap`` of the port against the reference under
    the cell's limit when sound; over it with each fault planted in the
    port's activation."""
    gen, ref = seeded(TINY, seed=7)
    if fault is not None:
        module, name, bad = FAULTS[fault]
        monkeypatch.setattr(ac, "SNAKE", ac.snake_beta, raising=False)
        monkeypatch.setattr(module, name, bad)
    m = mel(40, b=2, seed=8)
    with torch.no_grad():
        got, want = gen(m).numpy(), ref(m).numpy()
    gap = wave_gap(list(got), want, [40, 31], 4)
    if fault is None:
        assert gap <= WAVE_LIMIT / 10
    else:
        assert gap > WAVE_LIMIT


# -- on a card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from iris_tts_tpu_torch.runtime import pin_math_precision

    pin_math_precision()
    return torch.device("cuda")


# The main path's six stages at 32 rows × 768 frames: (channels, rate).
MAIN_PATH = [(768, 4), (384, 16), (192, 32), (96, 64), (48, 128), (24, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("channels, rate", MAIN_PATH)
def test_kernel_matches_the_composition_at_main_path_shapes(card, channels,
                                                            rate):
    g = torch.Generator(device=card).manual_seed(channels)
    x = torch.randn(32, channels, 768 * rate, generator=g, device=card)
    alpha = torch.randn(channels, generator=g, device=card) * 0.5
    beta = torch.randn(channels, generator=g, device=card) * 0.5
    h = ac.kaiser_sinc_filter().to(card)
    with torch.no_grad():
        launches = ac.amp_cuda.launches
        got = ac.amp_cuda(x, alpha, beta)
        want = ac.amp_plain(x, alpha, beta, h)
    torch.cuda.synchronize()
    assert ac.amp_cuda.launches == launches + 1
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("t", list(range(1, 17)) + [1023, 1024, 1025, 4099])
def test_kernel_edges_and_tiles_on_the_card(card, t):
    g = torch.Generator(device=card).manual_seed(t)
    x = torch.randn(3, 5, t, generator=g, device=card) * 3
    alpha = torch.randn(5, generator=g, device=card) * 0.5
    beta = torch.randn(5, generator=g, device=card) * 0.5
    with torch.no_grad():
        got = ac.amp_cuda(x, alpha, beta)
        want = ac.amp_plain(x, alpha, beta, ac.kaiser_sinc_filter().to(card))
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_kernel_window_equals_the_whole_signal(card):
    """Every output is summed in one order whatever its tile: a window
    equals the whole signal's samples wherever both see the same inputs."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(2, 6, 5000, generator=g, device=card)
    alpha = torch.randn(6, generator=g, device=card) * 0.5
    beta = torch.randn(6, generator=g, device=card) * 0.5
    with torch.no_grad():
        whole = ac.amp_cuda(x, alpha, beta)
        part = ac.amp_cuda(x[..., 1337:3900].contiguous(), alpha, beta)
    assert torch.equal(part[..., 5:-5], whole[..., 1342:3895])


@pytest.mark.cuda
def test_generator_runs_every_activation_on_the_kernel(card):
    gen, ref = seeded(TINY, seed=9)
    gen, ref = gen.to(card), ref.to(card)
    m = mel(300, b=3, seed=10).to(card)
    before = prof.counters()
    with torch.no_grad(), torch.profiler.profile():
        got = gen(m)
    after = prof.counters()
    assert after.get("vocoder.amp_fused", 0) - before.get(
        "vocoder.amp_fused", 0) == 17
    assert after.get("vocoder.amp_library", 0) == before.get(
        "vocoder.amp_library", 0)
    with torch.no_grad():
        want = ref(m)
    assert rel(got.cpu(), want.cpu()) <= 1e-5


def test_the_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="no anti-aliased activation kernel"):
        ac.amp_cuda(torch.zeros(1, 2, 8), torch.zeros(2), torch.zeros(2))


@pytest.mark.parametrize("case", ["grad", "bf16", "compiling"])
def test_off_the_cpu_the_generator_raises_where_the_kernel_does_not_run(
        case, monkeypatch):
    """Off the CPU BigVGAN runs f32 inference on the kernel and has no
    plain fallback: with gradients on, in bf16 or under export tracing an
    activation raises (meta tensors take the card's path)."""
    act = tb.Activation1d(4).to("meta")
    x = torch.zeros(1, 4, 16, device="meta")
    if case == "bf16":
        x = x.bfloat16()
    if case == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with torch.set_grad_enabled(case == "grad"), \
            pytest.raises(ValueError, match="f32 inference on the card"):
        act(x)
