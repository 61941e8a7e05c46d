"""Port parity: each model module of the PyTorch port against its JAX
counterpart, same weights (carried by state_dict_from_jax), same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tts_tpu.models.discriminators import HiFiGANDiscriminators as JDisc
from iris_tts_tpu.models.encoder import DurationPredictor as JDur
from iris_tts_tpu.models.encoder import PhonemeEncoder as JEnc
from iris_tts_tpu.models.hifigan import HiFiGANGenerator as JHiFi
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.models.postnet import PostNet as JPostNet
from iris_tts_tpu.models.vae import TextConditionedVAE as JVAE
from iris_tts_tpu_torch.convert.from_jax import (
    module_state_from_jax,
    state_dict_from_jax,
)
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.pipeline import SynthesisModel
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE
from tests.torch_port_utils import (
    load_port_module,
    max_abs,
    numpy_tree,
    port_config,
    small_config,
)

torch.set_num_threads(2)

CFG = small_config()
PCFG = port_config(CFG)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def test_encoder_with_padding_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CFG.encoder.vocab_size, size=(3, 12))
    lengths = np.array([12, 7, 0])  # the last row is all padding
    mask = np.arange(12)[None] < lengths[:, None]
    jenc = JEnc(config=CFG.encoder)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(ids),
                                 padding_mask=jnp.asarray(mask)))
    enc = load_port_module(PhonemeEncoder(PCFG.encoder), "encoder", params)
    with torch.no_grad():
        got = enc(_t(ids, torch.long), padding_mask=_t(mask, torch.bool))
    assert torch.isfinite(got).all()  # fully padded rows stay finite
    assert float(got[2].abs().max()) == 0.0
    assert max_abs(got, want) <= 1e-5


def test_duration_head_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, CFG.encoder.embed_dim)).astype(np.float32)
    jdur = JDur(config=CFG.duration)
    params = jdur.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(jdur.apply({"params": params}, jnp.asarray(x)))
    dur = load_port_module(
        DurationPredictor(CFG.encoder.embed_dim, PCFG.duration), "duration",
        params)
    with torch.no_grad():
        got = dur(_t(x))
    assert max_abs(got, want) <= 1e-5


def test_vae_generate_matches_jax_with_shared_prior():
    rng = np.random.default_rng(2)
    t = 24  # a multiple of the down factor (4)
    cond = rng.standard_normal((2, t, CFG.vae.cond_dim)).astype(np.float32)
    z = rng.standard_normal(
        (2, t // CFG.vae.down_factor, CFG.vae.latent_dim)).astype(np.float32)
    jvae = JVAE(config=CFG.vae)
    params = jvae.init(
        {"params": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)},
        jnp.zeros((1, t, CFG.vae.n_mels)), jnp.zeros((1, t, CFG.vae.cond_dim)),
    )["params"]
    # The zero-initialised flow output convs would make the inverse flow an
    # identity: perturb every leaf so each coupling is exercised.
    leaves, treedef = jax.tree_util.tree_flatten(params)
    prng = np.random.default_rng(5)
    params = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(l) + 0.05 * prng.standard_normal(l.shape).astype(np.float32)
        for l in leaves])
    want_mel, want_res = jvae.apply(
        {"params": params}, jnp.asarray(cond), z_prior=jnp.asarray(z),
        method=JVAE.generate)
    vae = load_port_module(TextConditionedVAE(PCFG.vae), "vae", params)
    with torch.no_grad():
        mel, res = vae.generate(_t(cond), z_prior=_t(z))
    assert max_abs(mel, want_mel) <= 1e-4
    assert max_abs(res, want_res) <= 1e-4


def test_postnet_with_batch_stats_matches_jax():
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, 16, CFG.postnet.n_mels)).astype(np.float32)
    jpn = JPostNet(config=CFG.postnet)
    variables = jpn.init(jax.random.PRNGKey(6), jnp.asarray(mel))
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    # Non-trivial running statistics (init is mean 0, var 1).
    srng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map(
        lambda a: (a + srng.uniform(0.2, 1.5, a.shape)).astype(np.float32),
        stats)
    variables = {"params": variables["params"], "batch_stats": stats}
    want = np.asarray(jpn.apply(variables, jnp.asarray(mel)))
    pn = load_port_module(PostNet(PCFG.postnet), "postnet", variables)
    with torch.no_grad():
        got = pn(_t(mel))
    assert max_abs(got, want) <= 1e-5


def test_hifigan_matches_jax():
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 20, CFG.hifigan.in_channels)).astype(
        np.float32)
    jg = JHiFi(config=CFG.hifigan)
    params = jg.init(jax.random.PRNGKey(8), jnp.asarray(mel[:1, :8]))["params"]
    # normal(0.01) init leaves the output near zero; scale the kernels up so
    # the comparison sees a signal of order one.
    SCALE = 15.0  # output of order 0.5, not saturated
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) * (SCALE if p[-1].key == "kernel" else 1.0),
        params)
    want = np.asarray(jg.apply({"params": params}, jnp.asarray(mel)))
    gen = load_port_module(HiFiGANGenerator(PCFG.hifigan), "hifigan", params)
    with torch.no_grad():
        got = gen(_t(mel))
    assert got.shape == (2, 20 * 256)
    assert float(np.abs(want).max()) > 0.05
    assert max_abs(got, want) <= 1e-4


def test_converter_consumes_every_leaf_once():
    jpipe = JPipeline.initialize(CFG, seed=0)
    params = numpy_tree(jpipe.params)
    model = SynthesisModel(port_config(jpipe.config))
    sd = state_dict_from_jax(params, model)
    # Every torch key is set, and every JAX leaf lands in exactly one key.
    assert set(sd) == set(model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == n_leaves
    model.load_state_dict(sd, strict=True)
    # A stray leaf is refused, not dropped.
    params["hifigan"]["stray"] = {"unknown_leaf": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        state_dict_from_jax(params)
    # The training slice's trees: the discriminators (4-D MPD kernels,
    # grouped MSD convs) and a PostNet stage's params + batch_stats.
    jd = JDisc(width=0.125)
    disc_params = numpy_tree(jax.jit(jd.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1024)))["params"])
    disc = HiFiGANDiscriminators(width=0.125)
    dsd = module_state_from_jax(disc_params, module=disc)
    assert len(dsd) == len(jax.tree_util.tree_leaves(disc_params))
    disc.load_state_dict(dsd, strict=True)
    pn = numpy_tree(jpipe.params["postnet"])
    psd = module_state_from_jax(pn["params"], pn["batch_stats"],
                                PostNet(PCFG.postnet))
    assert len(psd) - sum(k.endswith("num_batches_tracked") for k in psd) \
        == len(jax.tree_util.tree_leaves(pn))
    disc_params["mpd"]["period_3"]["stray"] = {"scale": np.zeros(2)}
    with pytest.raises(ValueError, match="unknown"):
        module_state_from_jax(disc_params, module=disc)
