"""bf16 compute in the PyTorch port against the JAX package's bf16, on the
CPU at small widths.

Each module runs in bf16 in both packages with the same weights (params
stay f32 in both) and the same seeded numpy inputs. Tolerance: the port's
bf16 output may differ from JAX's bf16 output by at most twice JAX's own
bf16-vs-f32 gap on the same input (both round at different places: cuDNN /
oneDNN add the bias in f32, XLA in bf16), and the gap must be non-zero, so
bf16 really ran. The pipeline is held, port bf16 against port f32, to the
JAX package's own gate (``tests/test_pipeline.py::
test_bfloat16_parity_with_float32``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from iris_tts_tpu.models.discriminators import HiFiGANDiscriminators as JDisc
from iris_tts_tpu.models.encoder import DurationPredictor as JDur
from iris_tts_tpu.models.encoder import PhonemeEncoder as JEnc
from iris_tts_tpu.models.hifigan import HiFiGANGenerator as JHiFi
from iris_tts_tpu.models.layers import Conv1d as JConv1d
from iris_tts_tpu.models.layers import Conv2dSmall as JConv2d
from iris_tts_tpu.models.layers import ConvTranspose1d as JConvT
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.models.postnet import PostNet as JPostNet
from iris_tts_tpu.models.vae import TextConditionedVAE as JVAE
from iris_tts_tpu.ops import length as jlength
from iris_tts_tpu.ops import losses as jlosses
from iris_tts_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from iris_tts_tpu.train import steps as jsteps
from iris_tts_tpu.train.state import TrainState as JState
from iris_tts_tpu.train.state import adam_clipped as jax_adam_clipped
from iris_tts_tpu_torch import config as port_cfg
from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import (
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    Dense,
    module_dtype,
)
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE
from iris_tts_tpu_torch.ops import length as tlength
from iris_tts_tpu_torch.ops import losses as tlosses
from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram
from iris_tts_tpu_torch.runtime import resolve_dtype
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from iris_tts_tpu_torch.train.steps import make_duration_train_step
from tests.test_torch_train import CFG as TRAIN_CFG
from tests.test_torch_train import JCFG as JTRAIN_CFG
from tests.test_torch_train import _batch, _j, _t
from tests.torch_port_utils import (
    load_port_module,
    max_abs,
    numpy_tree,
    port_config,
    small_config,
)

torch.set_num_threads(2)

BF16 = torch.bfloat16
CFG = small_config()
PCFG = port_config(CFG)


def _f(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _perturbed(params, seed, scale=0.05):
    """Every leaf moved off its init, so zero-initialised heads and the
    flow's output convs carry signal."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(l) + scale * rng.standard_normal(l.shape).astype(np.float32)
        for l in leaves])


def assert_within_jax_bf16_gap(got16, want16, want32, what=""):
    """The port's bf16 output against JAX's bf16, ≤ 2× JAX's own
    bf16-vs-f32 gap (which must be non-zero); ``got16`` is bf16."""
    if isinstance(got16, torch.Tensor):
        assert got16.dtype == BF16, (what, got16.dtype)
    gap = max_abs(np.asarray(want16, np.float32), want32)
    assert gap > 0, f"{what}: bf16 changed nothing"
    err = max_abs(got16.float() if isinstance(got16, torch.Tensor)
                  else got16, np.asarray(want16, np.float32))
    assert err <= 2 * gap, (what, err, gap)


# -- layers --------------------------------------------------------------------


def _layer_case(name):
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((2, 19, 12)).astype(np.float32)
    if name == "conv1d_same_stride2":
        j = lambda dt: JConv1d(16, 5, stride=2, dtype=dt)  # noqa: E731
        t = Conv1d(12, 16, 5, stride=2, dtype=BF16)
        x, tx = x1, _f(x1).transpose(1, 2)
    elif name == "conv1d_dilated_grouped":
        j = lambda dt: JConv1d(16, 3, dilation=2, groups=4,  # noqa: E731
                               dtype=dt)
        t = Conv1d(12, 16, 3, dilation=2, groups=4, dtype=BF16)
        x, tx = x1, _f(x1).transpose(1, 2)
    elif name == "conv_transpose1d":
        j = lambda dt: JConvT(8, 8, 4, dtype=dt)  # noqa: E731
        t = ConvTranspose1d(12, 8, 8, 4, dtype=BF16)
        x, tx = x1, _f(x1).transpose(1, 2)
    elif name == "conv2d":
        x = rng.standard_normal((2, 13, 3, 4)).astype(np.float32)
        j = lambda dt: JConv2d(8, (5, 1), strides=(3, 1),  # noqa: E731
                               padding=((2, 2), (0, 0)), dtype=dt)
        t = Conv2d(4, 8, (5, 1), stride=(3, 1), padding=((2, 2), (0, 0)),
                   dtype=BF16)
        tx = _f(x).permute(0, 3, 1, 2)
    else:  # dense
        j = lambda dt: fnn.Dense(16, dtype=dt)  # noqa: E731
        t = Dense(12, 16, dtype=BF16)
        x, tx = x1, _f(x1)
    return j, t, x, tx


@pytest.mark.parametrize("name", ["conv1d_same_stride2",
                                  "conv1d_dilated_grouped",
                                  "conv_transpose1d", "conv2d", "dense"])
def test_layer_bf16_matches_jax(name):
    """Each layer casts input, weight and bias to bf16 and returns bf16."""
    j, t, x, tx = _layer_case(name)
    params = _perturbed(j(jnp.float32).init(jax.random.PRNGKey(1),
                                            jnp.asarray(x))["params"], 2)
    want32 = np.asarray(j(jnp.float32).apply({"params": params},
                                             jnp.asarray(x)))
    want16 = np.asarray(j(jnp.bfloat16).apply({"params": params},
                                              jnp.asarray(x)), np.float32)
    # the converter reads a transposed conv off its flax name (ups_i)
    load_port_module(t, "ups_0" if name == "conv_transpose1d" else "m",
                     params)
    assert t.weight.dtype == torch.float32  # params stay f32
    with torch.no_grad():
        got = t(tx)
    if name == "conv2d":
        got = got.permute(0, 2, 3, 1)
    elif name != "dense":
        got = got.transpose(1, 2)
    assert_within_jax_bf16_gap(got, want16, want32, name)


# -- models --------------------------------------------------------------------


def test_encoder_and_duration_head_bf16_match_jax():
    """Embeddings cast, bf16 attention (mask at bf16's finfo.min, softmax
    in bf16), f32 LayerNorm statistics; a fully padded row stays zero."""
    rng = np.random.default_rng(1)
    ids = rng.integers(1, CFG.encoder.vocab_size, size=(3, 12))
    lengths = np.array([12, 7, 0])
    mask = np.arange(12)[None] < lengths[:, None]
    ep = _perturbed(JEnc(config=CFG.encoder).init(
        jax.random.PRNGKey(1), jnp.asarray(ids))["params"], 3)
    dp = _perturbed(JDur(config=CFG.duration).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 12, CFG.encoder.embed_dim))
    )["params"], 4)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        enc = JEnc(config=CFG.encoder, dtype=dt).apply(
            {"params": ep}, jnp.asarray(ids), padding_mask=jnp.asarray(mask))
        dur = JDur(config=CFG.duration, dtype=dt).apply({"params": dp}, enc)
        outs[dt] = (np.asarray(enc, np.float32), np.asarray(dur, np.float32))
    enc = load_port_module(PhonemeEncoder(PCFG.encoder, dtype=BF16),
                           "encoder", ep)
    dur = load_port_module(DurationPredictor(CFG.encoder.embed_dim,
                                             PCFG.duration, dtype=BF16),
                           "duration", dp)
    with torch.no_grad():
        got_enc = enc(_f(ids, torch.long), padding_mask=_f(mask, torch.bool))
        got_dur = dur(got_enc)
    assert float(got_enc[2].abs().max()) == 0.0
    assert_within_jax_bf16_gap(got_enc, outs[jnp.bfloat16][0],
                               outs[jnp.float32][0], "encoder")
    # The head sees each package's own bf16 encoder output.
    assert_within_jax_bf16_gap(got_dur[:2], outs[jnp.bfloat16][1][:2],
                               outs[jnp.float32][1][:2], "log-durations")


@pytest.fixture(scope="module")
def vae_params():
    t = 24
    params = JVAE(config=CFG.vae).init(
        {"params": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)},
        jnp.zeros((1, t, CFG.vae.n_mels)), jnp.zeros((1, t, CFG.vae.cond_dim)),
    )["params"]
    return _perturbed(params, 5)


def test_vae_generate_and_reconstruct_bf16_match_jax(vae_params):
    """The inverse flow and decode on a given latent, and the posterior-mean
    reconstruction, in bf16."""
    rng = np.random.default_rng(2)
    t = 24
    cond = rng.standard_normal((2, t, CFG.vae.cond_dim)).astype(np.float32)
    mel = rng.standard_normal((2, t, CFG.vae.n_mels)).astype(np.float32)
    z = rng.standard_normal(
        (2, t // CFG.vae.down_factor, CFG.vae.latent_dim)).astype(np.float32)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jv = JVAE(config=CFG.vae, dtype=dt)
        gen_mel, _ = jv.apply({"params": vae_params}, jnp.asarray(cond),
                              z_prior=jnp.asarray(z), method=JVAE.generate)
        recon = jv.apply({"params": vae_params}, jnp.asarray(mel),
                         jnp.asarray(cond))[0]
        outs[dt] = (np.asarray(gen_mel, np.float32),
                    np.asarray(recon, np.float32))
    vae = load_port_module(TextConditionedVAE(PCFG.vae, dtype=BF16), "vae",
                           vae_params)
    with torch.no_grad():
        gen_mel, _ = vae.generate(_f(cond), z_prior=_f(z))
        recon = vae(_f(mel), _f(cond))[0]
    assert_within_jax_bf16_gap(gen_mel, outs[jnp.bfloat16][0],
                               outs[jnp.float32][0], "generate")
    assert_within_jax_bf16_gap(recon, outs[jnp.bfloat16][1],
                               outs[jnp.float32][1], "reconstruct")


def test_vae_noise_is_drawn_in_f32_and_rounded_to_bf16(vae_params):
    """The prior's noise: an f32 draw from the explicit generator, rounded
    to the compute dtype (JAX draws in the compute dtype; the two packages'
    draws differ anyway)."""
    vae = load_port_module(TextConditionedVAE(PCFG.vae, dtype=BF16), "vae",
                           vae_params)
    cond = torch.zeros(1, 16, CFG.vae.cond_dim)
    g = torch.Generator().manual_seed(5)
    z32 = torch.randn((1, CFG.vae.latent_dim, 4), generator=g)
    with torch.no_grad():
        mel, _ = vae.generate(cond, temperature=0.5,
                              generator=torch.Generator().manual_seed(5))
        want, _ = vae.generate(cond, z_prior=(0.5 * z32.to(BF16)).transpose(
            1, 2))
    assert mel.dtype == BF16 and torch.equal(mel, want)


def test_postnet_bf16_matches_jax():
    """BatchNorm normalises in f32 and returns bf16 (inference, running
    statistics)."""
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, 16, CFG.postnet.n_mels)).astype(np.float32)
    variables = JPostNet(config=CFG.postnet).init(jax.random.PRNGKey(6),
                                                  jnp.asarray(mel))
    srng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + srng.uniform(0.2, 1.5, a.shape)).astype(
            np.float32), variables["batch_stats"])
    variables = {"params": _perturbed(variables["params"], 8),
                 "batch_stats": stats}
    # bf16 mel in, as the pipeline feeds it (the VAE's output).
    mel16 = np.asarray(jnp.asarray(mel, jnp.bfloat16), np.float32)
    outs = {dt: np.asarray(JPostNet(config=CFG.postnet, dtype=dt).apply(
        variables, jnp.asarray(mel16, dt)), np.float32)
        for dt in (jnp.float32, jnp.bfloat16)}
    pn = load_port_module(PostNet(PCFG.postnet, dtype=BF16), "postnet",
                          variables)
    assert pn.bn_0.running_mean.dtype == torch.float32
    with torch.no_grad():
        got = pn(_f(mel16).to(BF16))
    assert_within_jax_bf16_gap(got, outs[jnp.bfloat16], outs[jnp.float32],
                               "postnet")


def test_hifigan_bf16_matches_jax():
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((1, 10, 80)).astype(np.float32)
    params = JHiFi(config=CFG.hifigan).init(jax.random.PRNGKey(9),
                                            jnp.asarray(mel))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) * (15.0 if p[-1].key == "kernel" else 1.0),
        params)
    outs = {dt: np.asarray(JHiFi(config=CFG.hifigan, dtype=dt).apply(
        {"params": params}, jnp.asarray(mel)), np.float32)
        for dt in (jnp.float32, jnp.bfloat16)}
    gen = load_port_module(HiFiGANGenerator(PCFG.hifigan, dtype=BF16),
                           "hifigan", params)
    with torch.no_grad():
        got = gen(_f(mel))
    assert float(np.abs(outs[jnp.float32]).max()) > 0.05
    assert_within_jax_bf16_gap(got, outs[jnp.bfloat16], outs[jnp.float32],
                               "hifigan")


def test_discriminators_bf16_match_jax():
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal((2, 1024))).astype(np.float32)
    jd = JDisc(width=0.125)
    params = _perturbed(jd.init(jax.random.PRNGKey(10),
                                jnp.asarray(audio))["params"], 11, 0.02)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        logits, feats = JDisc(width=0.125, dtype=dt).apply(
            {"params": params}, jnp.asarray(audio))
        outs[dt] = (logits, feats)
    disc = load_port_module(HiFiGANDiscriminators(width=0.125, dtype=BF16),
                            "disc", params)
    with torch.no_grad():
        logits, feats = disc(_f(audio))
    for i, (l16, l32) in enumerate(zip(outs[jnp.bfloat16][0],
                                       outs[jnp.float32][0])):
        assert_within_jax_bf16_gap(logits[i], l16, l32, f"logits {i}")
    n_mpd = 5
    for i, (f, f16, f32) in enumerate(zip(feats, outs[jnp.bfloat16][1],
                                          outs[jnp.float32][1])):
        for k, (a, a16, a32) in enumerate(zip(f, f16, f32)):
            # the port keeps channels first: MPD [B, C, T/p, p], MSD [B, C, T]
            a = a.permute(0, 2, 3, 1) if i < n_mpd else a.transpose(1, 2)
            assert_within_jax_bf16_gap(a, a16, a32, f"feature {i}.{k}")


# -- ops -----------------------------------------------------------------------


@pytest.mark.parametrize("upsample", ["hard", "gaussian"])
def test_length_regulation_dtypes_follow_jax(upsample):
    """Hard regulation keeps the encoder's bf16; Gaussian upsampling's f32
    attention promotes the frames to f32, as JAX's einsum does; the mask is
    in the encoder's dtype in both."""
    rng = np.random.default_rng(6)
    enc = np.asarray(jnp.asarray(rng.standard_normal((2, 5, 8)),
                                 jnp.bfloat16), np.float32)
    dur = np.array([[2, 3, 1, 0, 0], [1, 1, 4, 2, 1]], np.int32)
    jfn = jlength.gaussian_upsample if upsample == "gaussian" else \
        jlength.length_regulate
    tfn = tlength.gaussian_upsample if upsample == "gaussian" else \
        tlength.length_regulate
    jdur = jnp.asarray(dur, jnp.float32 if upsample == "gaussian"
                       else jnp.int32)
    jf, jm = jfn(jnp.asarray(enc, jnp.bfloat16), jdur, 12)
    tf, tm = tfn(_f(enc).to(BF16), torch.from_numpy(dur), 12)
    assert str(tf.dtype).endswith(str(jf.dtype))
    assert str(tm.dtype).endswith(str(jm.dtype))
    assert max_abs(tf.float(), np.asarray(jf, np.float32)) <= (
        1e-6 if upsample == "gaussian" else 0.0)
    assert max_abs(tm.float(), np.asarray(jm, np.float32)) == 0.0


def test_frame_count_sum_is_exact_in_bf16():
    """Counterpart of the JAX package's test: frame counts are summed in
    int32, never in the bf16 mask's dtype (701 ones sum to 700 there)."""
    mask = torch.ones((1, 701), dtype=BF16)
    assert float(mask.sum(dim=1)[0]) == 700.0  # the failure mode
    n = tlength.frame_counts(mask)
    assert n.dtype == torch.int32 and int(n[0]) == 701


def test_losses_reduce_in_f32_for_bf16_inputs():
    """Counterpart of ``tests/test_losses.py::
    test_losses_reduce_in_f32_for_bf16_inputs``: each loss returns f32 and
    the exact value past bf16's integer-exact range."""
    n = 4097
    mean = torch.full((1, n, 2), 0.5, dtype=BF16)
    logvar = torch.zeros((1, n, 2), dtype=BF16)
    mask = torch.ones((1, n), dtype=BF16)
    kl = tlosses.kl_divergence(mean, logvar, mask)
    assert kl.dtype == torch.float32 and abs(float(kl) - 0.25) < 1e-5
    t = torch.ones((1, n, 4), dtype=BF16)
    p = torch.zeros((1, n, 4), dtype=BF16)
    l1 = tlosses.masked_l1_loss(t, p, mask)
    assert l1.dtype == torch.float32 and abs(float(l1) - 1.0) < 1e-3
    logits = [torch.full((2, n), 0.5, dtype=BF16)]
    d = tlosses.lsgan_discriminator_loss(logits, logits)
    g = tlosses.lsgan_generator_loss(logits)
    assert d.dtype == torch.float32 and abs(float(d) - 0.5) < 1e-5
    assert g.dtype == torch.float32 and abs(float(g) - 0.25) < 1e-5
    fm = tlosses.feature_matching_loss([[t]], [[p]])
    assert fm.dtype == torch.float32 and abs(float(fm) - 1.0) < 1e-5
    dh = tlosses.duration_huber_loss(torch.zeros((1, n), dtype=BF16),
                                     torch.ones((1, n)), mask)
    assert dh.dtype == torch.float32
    # and they agree with the JAX package's on the same bf16 inputs
    assert abs(float(kl) - float(jlosses.kl_divergence(
        jnp.full((1, n, 2), 0.5, jnp.bfloat16),
        jnp.zeros((1, n, 2), jnp.bfloat16),
        jnp.ones((1, n), jnp.bfloat16)))) < 1e-6


def test_log_mel_on_bf16_audio_returns_bf16_equal_to_jax_xla():
    """The ``impl="xla"`` composition on bf16 audio rounds the magnitude to
    bf16 before the mel projection and returns bf16, as JAX's does; the
    kernel's CPU stand-in (the plain version) computes in f32 and returns
    bf16."""
    cfg = AudioConfig()
    rng = np.random.default_rng(7)
    audio = np.asarray(jnp.asarray(0.3 * rng.standard_normal((2, 5000)),
                                   jnp.bfloat16))
    want = jax_log_mel(jnp.asarray(audio), cfg, impl="xla")
    assert want.dtype == jnp.bfloat16
    ta = _f(np.asarray(audio, np.float32)).to(BF16)
    got = log_mel_spectrogram(ta, cfg, impl="xla")
    assert got.dtype == BF16
    want = np.asarray(want, np.float32)
    got_np = got.float().numpy()
    # Within one bf16 ulp of JAX's, not bitwise: where the two packages' f32
    # DFT matmuls (summed in other orders) put a magnitude on the other
    # side of a bf16 rounding boundary, the rounded bin moves the mels it
    # feeds, and their final bf16 rounding can go the other way.
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got_np - want) <= ulp)
    assert np.mean(got_np == want) > 0.8
    plain = log_mel_spectrogram(ta, cfg)
    assert plain.dtype == BF16
    f32 = log_mel_spectrogram(ta.float(), cfg)
    assert torch.equal(plain, f32.to(BF16))


# -- pipeline --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pipeline():
    jpipe = JPipeline.initialize(small_config(), seed=3)
    return dataclasses.replace(jpipe, phoneme_buckets=(16, 32, 64),
                               frame_buckets=(16, 32, 64, 128, 256, 512))


@pytest.fixture(scope="module")
def pipe32(jax_pipeline):
    pipe = TTSPipeline.from_jax_params(numpy_tree(jax_pipeline.params),
                                       port_config(jax_pipeline.config),
                                       device="cpu")
    return dataclasses.replace(pipe, phoneme_buckets=(16, 32, 64),
                               frame_buckets=(16, 32, 64, 128, 256, 512))


GATE_TEXT = "The old gardener found a basket of apples."


def duration_clearance(pipe, text: str) -> float:
    """How far the duration head's ``exp(p) - 1`` (in the pipeline's
    compute dtype, as ``durations_from_log`` takes it) lies from a .5
    rounding boundary at its closest phoneme: frame counts compare only
    when it is clear in both dtypes."""
    ids, lengths = pipe._encode_texts([text])
    with torch.no_grad():
        mask = tlength.padding_mask(torch.from_numpy(lengths), ids.shape[1])
        enc = pipe.model.encoder(torch.from_numpy(ids), padding_mask=mask)
        x = torch.exp(pipe.model.duration(enc)) - 1.0
    x = x.double().numpy()[0, :lengths[0]]
    return float(np.abs((x - np.floor(x)) - 0.5).min())


def test_bfloat16_pipeline_passes_jaxs_gate(pipe32):
    """Port bf16 against port f32 at temperature 0 under the JAX package's
    gate: mel max|Δ| < 0.05, mean|Δ| < 0.01, audio max|Δ| < 1e-3, equal
    frame counts, f32 audio and mels from the public API. The sentence's
    durations are clear of a rounding boundary in both dtypes (on these
    weights bf16 lands some of "The quick brown fox ..." exactly on .5)."""
    pipe16 = dataclasses.replace(pipe32, dtype=torch.bfloat16)
    assert duration_clearance(pipe32, GATE_TEXT) > 0.02
    assert duration_clearance(pipe16, GATE_TEXT) > 0.02
    assert module_dtype(pipe32.model) == torch.float32  # not aliased
    assert module_dtype(pipe16.model) == BF16
    assert pipe16.model.hifigan.conv_pre.weight is \
        pipe32.model.hifigan.conv_pre.weight  # same params, no copy
    a32, m32 = pipe32.synthesize(GATE_TEXT, seed=7, temperature=0.0,
                                 return_mel=True)
    a16, m16 = pipe16.synthesize(GATE_TEXT, seed=7, temperature=0.0,
                                 return_mel=True)
    assert len(a32) == len(a16) and m32.shape == m16.shape
    d_mel = np.abs(m32 - m16)
    assert 0 < d_mel.max() < 0.05 and d_mel.mean() < 0.01
    assert np.abs(a32 - a16).max() < 1e-3
    assert a16.dtype == np.float32 and m16.dtype == np.float32


def test_bfloat16_pipeline_entry_points(pipe32, tmp_path):
    """Every entry point of a bf16 pipeline: two-stage batch, synthesize_mel,
    vocode of a bf16 tensor mel (normalised to f32 first, as JAX does),
    vocode_streaming, stream, the batcher's dispatch/collect, Gaussian
    upsampling, overflow redo, save (f32 params) and load(dtype=)."""
    pipe16 = dataclasses.replace(pipe32, dtype=torch.bfloat16)
    outs = pipe16.synthesize(["Hello world.", "Speech!"], seed=1)
    assert all(o.dtype == np.float32 and o.size for o in outs)
    mel = pipe16.synthesize_mel("Hello world.", seed=1)
    assert mel.dtype == np.float32
    v32 = pipe16.vocode(mel)
    v16 = pipe16.vocode(torch.from_numpy(mel).to(BF16))
    assert v16.dtype == np.float32
    assert np.array_equal(pipe16.vocode(torch.from_numpy(mel).to(
        BF16).float()), v16)
    assert v32.shape == v16.shape
    long_mel = np.random.default_rng(0).standard_normal((120, 80)).astype(
        np.float32)
    chunks = list(pipe16.vocode_streaming(long_mel, chunk_frames=16))
    assert all(c.dtype == np.float32 for c in chunks)
    assert sum(len(c) for c in chunks) == 120 * 256
    parts = list(pipe16.stream("Hello there. How are you?", seed=2))
    assert all(np.isfinite(p).all() for p in parts)
    disp = pipe16._batched_dispatch(["Hello world.", "Speech!"], seed=1,
                                    temperature=0.0)
    got = pipe16._batched_collect(disp)
    want = pipe16.synthesize(["Hello world.", "Speech!"], seed=1,
                             temperature=0.0, fused=False)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    gauss = dataclasses.replace(pipe16, upsample="gaussian")
    assert gauss.synthesize("Hello world.", seed=1).dtype == np.float32
    tight = dataclasses.replace(pipe16, fused_frames_per_phoneme=1)
    assert tight.synthesize(GATE_TEXT, seed=1, temperature=0.0).size
    assert tight.fused_fallback_count >= 1
    pipe16.save(tmp_path / "p")
    loaded = TTSPipeline.load(tmp_path / "p", device="cpu", dtype="bf16")
    assert loaded.dtype == BF16
    assert all(p.dtype == torch.float32 for p in loaded.model.parameters())
    for k, v in pipe32.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    assert np.array_equal(
        loaded.synthesize(GATE_TEXT, seed=3, temperature=0.0),
        pipe16.synthesize(GATE_TEXT, seed=3, temperature=0.0))


def test_constructors_take_dtype(jax_pipeline):
    """initialize, from_jax_params and resolve_dtype accept the JAX
    package's spellings; an unknown dtype raises."""
    pcfg = small_config(port_cfg)
    p = TTSPipeline.initialize(pcfg, device="cpu", dtype=torch.bfloat16)
    assert p.dtype == BF16 and module_dtype(p.model) == BF16
    q = TTSPipeline.from_jax_params(numpy_tree(jax_pipeline.params),
                                    port_config(jax_pipeline.config),
                                    device="cpu", dtype="bfloat16")
    assert module_dtype(q.model) == BF16
    assert resolve_dtype(None) == torch.float32
    with pytest.raises(ValueError):
        resolve_dtype(torch.float16)


# -- training ------------------------------------------------------------------


def _duration_module():
    return torch.nn.ModuleDict({
        "encoder": PhonemeEncoder(TRAIN_CFG.encoder),
        "duration": DurationPredictor(16, TRAIN_CFG.duration)})


def test_bf16_mixed_precision_training_matches_jax():
    """Counterpart of ``tests/test_train_steps.py::
    test_bf16_mixed_precision_training``: the duration step in bf16 tracks
    the f32 step within that test's gate (5% of the loss) and its loss
    falls, params and Adam state stay f32, and the modules go back to f32
    after the step; over 5 steps from the same weights and batches the
    port's bf16 losses follow JAX's bf16 losses within the same gate. A
    loss is a poor place for a 2×-gap bound: exp(p) amplifies a one-ulp
    bf16 difference in a log-duration, and JAX's own bf16-vs-f32 loss gap
    can be small by cancellation (3e-3 at step 0 here, where the port's
    bf16 loss is 0.1 from JAX's); the log-durations themselves are held to
    2× the gap in ``test_encoder_and_duration_head_bf16_match_jax``."""
    from iris_tts_tpu.models.encoder import DurationPredictor as JD
    from iris_tts_tpu.models.encoder import PhonemeEncoder as JE
    from tests.test_torch_train import _port

    key = jax.random.PRNGKey(0)
    ids = jnp.zeros((1, 7), jnp.int32)
    params = {
        "encoder": _perturbed(JE(config=JTRAIN_CFG.encoder).init(
            key, ids)["params"], 1),
        "duration": _perturbed(JD(config=JTRAIN_CFG.duration).init(
            key, jnp.zeros((1, 7, 16)))["params"], 2)}
    jsteps16 = jax.jit(jsteps.make_duration_train_step(
        JTRAIN_CFG, compute_dtype=jnp.bfloat16))
    jsteps32 = jax.jit(jsteps.make_duration_train_step(JTRAIN_CFG))
    j16 = JState.create(params, jax_adam_clipped(1e-3, 1.0), key)
    j32 = JState.create(params, jax_adam_clipped(1e-3, 1.0), key)
    m16 = _port(_duration_module(), params)
    m32 = _port(_duration_module(), params)
    s16 = TrainState.create(m16, adam_clipped(1e-3, 1.0), 0)
    s32 = TrainState.create(m32, adam_clipped(1e-3, 1.0), 0)
    step16 = make_duration_train_step(TRAIN_CFG, compute_dtype=BF16)
    step32 = make_duration_train_step(TRAIN_CFG)
    losses16 = []
    for i in range(5):
        b = _batch(i)
        j16, jm16 = jsteps16(j16, _j(b))
        j32, jm32 = jsteps32(j32, _j(b))
        s16, tm16 = step16(s16, _t(b))
        s32, tm32 = step32(s32, _t(b))
        l16, l32 = float(tm16["duration_loss"]), float(tm32["duration_loss"])
        assert tm16["duration_loss"].dtype == torch.float32
        assert abs(l16 - l32) < 0.05 * max(1.0, l32)
        jl16, jl32 = (float(jm16["duration_loss"]),
                      float(jm32["duration_loss"]))
        assert abs(jl16 - jl32) < 0.05 * max(1.0, jl32)  # JAX's own gate
        assert abs(l16 - jl16) < 0.05 * max(1.0, jl32), (i, l16, jl16)
        losses16.append(l16)
    assert losses16[-1] < losses16[0]
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    assert all(v.dtype == torch.float32 for st in
               s16.optimizer.state_dict()["state"].values()
               for v in st.values() if torch.is_tensor(v) and v.ndim)
    assert module_dtype(m16) == torch.float32  # restored after the step
