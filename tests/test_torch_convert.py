"""Port parity: the checkpoint converters (``convert/hifigan_torch.py``,
``convert/torch_oracle.py``, ``convert/keras_h5.py``, ``convert/to_jax.py``),
``TorchConv1d`` / ``TorchConvTranspose1d``,
``TTSPipeline.from_checkpoints(hifigan_checkpoint=)`` and the scripts
that use them, against the JAX package's.

No real artifact is in the repository, so every converter is held to the
JAX converter on seeded fixtures: torch state dicts from the oracle in
each weight form and nesting, and a Keras ``.weights.h5`` written with
h5py at the group paths of the layout contract from seeded arrays shaped
as the JAX modules' trees (the JAX converter must read that file back as
exactly those trees first). Tolerances: single convs 2e-5 (JAX's own);
converted generators ≤ 1e-5 of JAX's at a reduced config and ≤ 1e-4 of
the oracle at the production config (87 frames; torch against torch);
Keras stages ≤ 1e-5 of JAX's module outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

import iris_tts_tpu.config as jcfg
from iris_tts_tpu.convert import hifigan_torch as jconv
from iris_tts_tpu.convert import keras_h5 as jkeras
from iris_tts_tpu.convert.torch_oracle import TorchGenerator as JaxOracle
from iris_tts_tpu.models import hifigan as jhifi
from iris_tts_tpu_torch.config import HiFiGANConfig, IrisConfig
from iris_tts_tpu_torch.convert import hifigan_torch, keras_h5
from iris_tts_tpu_torch.convert.from_jax import module_state_from_jax
from iris_tts_tpu_torch.convert.to_jax import jax_params_from_module
from iris_tts_tpu_torch.convert.torch_oracle import TorchGenerator
from iris_tts_tpu_torch.models import (
    DurationPredictor,
    HiFiGANGenerator,
    PhonemeEncoder,
    PostNet,
    TextConditionedVAE,
    TorchConv1d,
    TorchConvTranspose1d,
)
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from torch_port_utils import max_abs, port_config, small_config

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*weight_norm.*:FutureWarning")

SMALL = dict(in_channels=10, upsample_rates=(4, 2),
             upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
             resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 3), (1, 3)))


def _wn(mod):
    return tnn.utils.weight_norm(mod)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Single convs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5), (5, 2)])
def test_torch_conv1d_matches_jax(k, d):
    torch.manual_seed(0)
    c_in, c_out, t = 6, 9, 32
    tconv = _wn(tnn.Conv1d(c_in, c_out, k, dilation=d,
                           padding=(k * d - d) // 2))
    x = np.random.default_rng(k * 10 + d).standard_normal(
        (2, t, c_in)).astype(np.float32)
    sd = {f"layer.{n}": v for n, v in tconv.state_dict().items()}
    jmod = jhifi.TorchConv1d(c_out, k, dilation=d)
    want = np.asarray(jmod.apply({"params": {
        "kernel": jconv._conv_kernel(sd, "layer"),
        "bias": sd["layer.bias"].numpy()}}, jnp.asarray(x)))
    conv = TorchConv1d(c_in, c_out, k, dilation=d)
    out = {}
    hifigan_torch._layer(sd, "layer", "c", out)
    conv.load_state_dict({"weight": out["c.weight"], "bias": out["c.bias"]})
    with torch.no_grad():
        got = conv(_t(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == want.shape
    assert max_abs(got, want) <= 2e-5


@pytest.mark.parametrize("k,u", [(16, 8), (4, 2), (8, 4), (6, 2)])
def test_torch_conv_transpose1d_matches_jax(k, u):
    torch.manual_seed(1)
    c_in, c_out, t = 8, 4, 16
    tconv = _wn(tnn.ConvTranspose1d(c_in, c_out, k, u,
                                    padding=(k - u) // 2))
    x = np.random.default_rng(k * 10 + u).standard_normal(
        (2, t, c_in)).astype(np.float32)
    sd = {f"layer.{n}": v for n, v in tconv.state_dict().items()}
    jmod = jhifi.TorchConvTranspose1d(c_out, k, u)
    want = np.asarray(jmod.apply({"params": {
        "kernel": jconv._conv_transpose_kernel(sd, "layer"),
        "bias": sd["layer.bias"].numpy()}}, jnp.asarray(x)))
    assert want.shape[1] == t * u
    conv = TorchConvTranspose1d(c_in, c_out, k, u)
    out = {}
    hifigan_torch._layer(sd, "layer", "c", out)
    conv.load_state_dict({"weight": out["c.weight"], "bias": out["c.bias"]})
    with torch.no_grad():
        got = conv(_t(x).transpose(1, 2)).transpose(1, 2)
    assert max_abs(got, want) <= 2e-5


# ---------------------------------------------------------------------------
# Whole generators: weight forms and nestings
# ---------------------------------------------------------------------------


def _weight_form(sd, form):
    """The oracle's weight_g / weight_v state dict in ``form``."""
    if form == "weight_norm":
        return dict(sd)
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            stem = k[: -len(".weight_g")]
            if form == "parametrizations":
                out[f"{stem}.parametrizations.weight.original0"] = v
                out[f"{stem}.parametrizations.weight.original1"] = \
                    sd[f"{stem}.weight_v"]
            else:  # folded
                w = sd[f"{stem}.weight_v"]
                norm = w.norm(dim=tuple(range(1, w.ndim)), keepdim=True)
                out[f"{stem}.weight"] = w * (v / norm)
        elif not k.endswith(".weight_v"):
            out[k] = v
    return out


def _nesting(sd, nest):
    if nest == "speechbrain":  # nnet.CNN holds the conv as ``.conv``
        return {f"{k.rsplit('.', 1)[0]}.conv.{k.rsplit('.', 1)[1]}": v
                for k, v in sd.items()}
    if nest in ("module.", "generator."):
        return {nest + k: v for k, v in sd.items()}
    return dict(sd)


def test_port_oracle_is_bitwise_jaxs():
    torch.manual_seed(5)
    theirs = JaxOracle(jcfg.HiFiGANConfig(**SMALL)).eval()
    ours = TorchGenerator(HiFiGANConfig(**SMALL)).eval()
    ours.load_state_dict(theirs.state_dict(), strict=True)
    x = torch.randn(2, SMALL["in_channels"], 13)
    with torch.no_grad():
        assert torch.equal(ours(x), theirs(x))


@pytest.fixture(scope="module")
def small_oracle():
    torch.manual_seed(7)
    oracle = TorchGenerator(HiFiGANConfig(**SMALL)).eval()
    # conv_post's normal(0.01)-scale weights give a near-zero waveform;
    # larger g's make the comparison see the whole generator.
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if name.endswith("weight_g"):
                p.mul_(20.0)
    jgen = jhifi.HiFiGANGenerator(config=jcfg.HiFiGANConfig(**SMALL))
    return oracle, jax.jit(lambda p, m: jgen.apply({"params": p}, m))


@pytest.mark.parametrize("nest", ["plain", "speechbrain", "module.",
                                  "generator."])
@pytest.mark.parametrize("form", ["weight_norm", "parametrizations",
                                  "folded"])
def test_converted_generator_matches_jax(small_oracle, form, nest):
    oracle, jax_apply = small_oracle
    sd = _nesting(_weight_form(oracle.state_dict(), form), nest)
    cfg = HiFiGANConfig(**SMALL)
    mel = np.random.default_rng(1).standard_normal(
        (2, 20, SMALL["in_channels"])).astype(np.float32)
    want = np.asarray(jax_apply(
        jconv.convert_hifigan_state_dict(sd, jcfg.HiFiGANConfig(**SMALL)),
        jnp.asarray(mel)))
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(hifigan_torch.convert_hifigan_state_dict(sd, cfg),
                        strict=True)
    with torch.no_grad():
        got = gen.eval()(_t(mel))
    assert float(np.abs(want).max()) > 1e-3
    assert max_abs(got, want) <= 1e-5


@pytest.mark.parametrize("form", ["weight_norm", "parametrizations",
                                  "folded"])
def test_production_generator_matches_oracle(form):
    """Production HiFiGANConfig, 87 frames, torch against torch."""
    torch.manual_seed(11)
    cfg = HiFiGANConfig()
    oracle = TorchGenerator(cfg).eval()
    sd = _nesting(_weight_form(oracle.state_dict(), form), "speechbrain")
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(hifigan_torch.convert_hifigan_state_dict(sd, cfg),
                        strict=True)
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 87, cfg.in_channels)).astype(np.float32))
    with torch.no_grad():
        want = oracle(mel.transpose(1, 2))[:, 0]
        got = gen.eval()(mel)
    assert got.shape == (1, 87 * cfg.total_upsample)
    assert max_abs(got, want) <= 1e-4


def test_missing_layer_raises():
    sd = TorchGenerator(HiFiGANConfig(**SMALL)).state_dict()
    del sd["ups.1.weight_v"], sd["ups.1.weight_g"]
    with pytest.raises(KeyError, match="ups.1"):
        hifigan_torch.convert_hifigan_state_dict(sd, HiFiGANConfig(**SMALL))


def test_load_torch_checkpoint_unwraps_nested_dicts(tmp_path):
    sd = TorchGenerator(HiFiGANConfig(**SMALL)).state_dict()
    for i, wrap in enumerate([sd, {"generator": sd}, {"model": sd},
                              {"state_dict": sd, "epoch": 3}]):
        path = tmp_path / f"c{i}.ckpt"
        torch.save(wrap, path)
        got = hifigan_torch.load_torch_checkpoint(path)
        assert set(got) == set(sd)


def test_infer_hifigan_reads_the_env_checkpoint(tmp_path, monkeypatch):
    torch.manual_seed(9)
    oracle = TorchGenerator(HiFiGANConfig()).eval()
    path = tmp_path / "generator.ckpt"
    torch.save(_nesting(oracle.state_dict(), "speechbrain"), path)
    monkeypatch.setenv("IRIS_HIFIGAN_CKPT", str(path))
    monkeypatch.setattr(hifigan_torch, "_vocoder_instance", None)
    assert hifigan_torch.default_checkpoint_path() == path
    mel = np.random.default_rng(3).standard_normal((80, 12)).astype(
        np.float32)
    audio = hifigan_torch.infer_hifigan(mel, device="cpu")
    with torch.no_grad():
        want = oracle(torch.from_numpy(mel)[None])[0, 0].numpy()
    assert audio.shape == (12 * 256,)
    assert max_abs(audio, want) <= 1e-4
    import iris_tts_tpu_torch

    assert iris_tts_tpu_torch.infer_hifigan is hifigan_torch.infer_hifigan
    assert (iris_tts_tpu_torch.get_pretrained_hifigan(device="cpu")
            is hifigan_torch.get_pretrained_hifigan(device="cpu"))


# ---------------------------------------------------------------------------
# from_checkpoints(hifigan_checkpoint=)
# ---------------------------------------------------------------------------


def _arpabet_config():
    """The small config with the default ARPABET vocab's size, which
    ``from_checkpoints`` uses when no vocab is given."""
    from dataclasses import replace

    from iris_tts_tpu_torch.text import PhonemeVocab

    cfg = port_config(small_config())
    return replace(cfg, encoder=replace(
        cfg.encoder, vocab_size=len(PhonemeVocab.default_arpabet())))


def _stage_checkpoints(root, cfg):
    from iris_tts_tpu_torch.models.layers import init_params
    from iris_tts_tpu_torch.runtime import seeded_generator
    from iris_tts_tpu_torch.train import CheckpointManager, TrainState
    from iris_tts_tpu_torch.train.state import adam_clipped

    enc = tnn.ModuleDict({
        "encoder": PhonemeEncoder(cfg.encoder),
        "duration": DurationPredictor(cfg.encoder.embed_dim, cfg.duration)})
    vae = TextConditionedVAE(cfg.vae)
    for i, m in enumerate((enc, vae)):
        init_params(m, seeded_generator(i, "cpu"))
    for name, m in (("encoder", enc), ("vae", vae)):
        CheckpointManager(root / name, cfg).save(
            1, TrainState.create(m, adam_clipped(1e-3), 0))
    return root / "encoder", root / "vae"


def test_from_checkpoints_takes_a_torch_hifigan(tmp_path):
    cfg = _arpabet_config()
    enc_dir, vae_dir = _stage_checkpoints(tmp_path, cfg)
    torch.manual_seed(4)
    path = tmp_path / "generator.ckpt"
    torch.save(_nesting(TorchGenerator(cfg.hifigan).state_dict(),
                        "speechbrain"), path)
    pipe = TTSPipeline.from_checkpoints(enc_dir, vae_dir,
                                        hifigan_checkpoint=path,
                                        device="cpu")
    want = hifigan_torch.load_pretrained_hifigan(path, cfg.hifigan,
                                                 device="cpu").params
    got = pipe.model.hifigan.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    audio = pipe.synthesize("Hello world.", seed=0)
    assert audio.ndim == 1 and np.isfinite(audio).all()
    with pytest.raises(ValueError, match="not both"):
        TTSPipeline.from_checkpoints(enc_dir, vae_dir,
                                     hifigan_checkpoint=path,
                                     hifigan_gan_checkpoint=tmp_path,
                                     device="cpu")


# ---------------------------------------------------------------------------
# The inverse mapping (convert/to_jax.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [1, 4, 6])
def test_to_jax_inverts_from_jax(heads):
    """Port G2P → flax tree → port state dict is the identity, and a layer
    with no flax layout here raises."""
    from iris_tts_tpu_torch.models.g2p import G2PTransformer
    from iris_tts_tpu_torch.models.layers import init_params
    from iris_tts_tpu_torch.runtime import seeded_generator
    from iris_tts_tpu_torch.text.neural_g2p import G2PConfig

    module = G2PTransformer(G2PConfig(embed_dim=48, num_heads=heads,
                                      enc_blocks=1, dec_blocks=2))
    init_params(module, seeded_generator(heads, "cpu"))
    tree = jax_params_from_module(module)
    q = tree["dec_1"]["cross_attention"]["query"]
    assert q["kernel"].shape == (48, heads, 48 // heads)
    assert tree["enc_0"]["attention"]["out"]["kernel"].shape == (
        heads, 48 // heads, 48)
    back = module_state_from_jax(tree, module=module)
    for k, v in module.state_dict().items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="no flax layout"):
        jax_params_from_module(HiFiGANGenerator(HiFiGANConfig(**SMALL)))


# ---------------------------------------------------------------------------
# Keras .weights.h5
# ---------------------------------------------------------------------------


def _sfx(i):
    return "" if i == 0 else f"_{i}"


def _dense(tree):
    return [tree["kernel"], tree["bias"]]


def _h5_groups(stage, tree, cfg):
    """The layout contract's group paths → variables, for a JAX module's
    tree (the inverse of the JAX converter)."""
    g = {}
    if stage == "encoder":
        g["/layers/embedding"] = [tree["phoneme_embedding"]["embedding"]]
        g["/layers/positional_embedding/position_embedding"] = [
            tree["position_embedding"]["embedding"]]
        g["/final_norm"] = [tree["output_norm"]["scale"],
                            tree["output_norm"]["bias"]]
        for i in range(cfg.encoder.num_blocks):
            blk, b = f"/layers/transformer_block{_sfx(i)}", tree[f"block_{i}"]
            for ours, theirs in (("query", "query_dense"),
                                 ("key", "key_dense"),
                                 ("value", "value_dense"),
                                 ("out", "output_dense")):
                g[f"{blk}/attention/{theirs}"] = _dense(
                    b["attention"][ours])
            g[f"{blk}/attention_norm"] = [b["attn_norm"]["scale"],
                                          b["attn_norm"]["bias"]]
            g[f"{blk}/ffn/layers/dense"] = _dense(b["ffn_in"])
            g[f"{blk}/ffn/layers/dense_1"] = _dense(b["ffn_out"])
            g[f"{blk}/ffn_norm"] = [b["ffn_norm"]["scale"],
                                    b["ffn_norm"]["bias"]]
    elif stage == "duration":
        n = cfg.duration.num_layers
        for i in range(n):
            g[f"/conv_layers/conv1d{_sfx(i)}"] = _dense(tree[f"conv_{i}"])
            g[f"/layers/layer_normalization{_sfx(i)}"] = [
                tree[f"norm_{i}"]["scale"], tree[f"norm_{i}"]["bias"]]
        g[f"/layers/conv1d{_sfx(n)}"] = _dense(tree["output_proj"])
    elif stage == "postnet":
        p, s = tree["params"], tree["batch_stats"]

        def bn(name):
            return [p[name]["scale"], p[name]["bias"], s[name]["mean"],
                    s[name]["var"]]

        for i in range(cfg.postnet.num_layers - 1):
            g[f"/convs/conv1d{_sfx(i)}"] = _dense(p[f"conv_{i}"])
            g[f"/bns/batch_normalization{_sfx(i)}"] = bn(f"bn_{i}")
        g["/conv_out"] = _dense(p["conv_out"])
        g["/bn_out"] = bn("bn_out")
    elif stage == "vae":
        for name in ("in_proj", "down_cond_proj", "latent_mean_proj",
                     "latent_logvar_proj", "latent_dec_proj"):
            g[f"/{name}"] = _dense(tree[name])
        g["/layers/conv1d_2"] = _dense(tree["out_proj"])
        g["/layers/dense_3"] = _dense(tree["residual_proj"])
        for side, n in (("enc", cfg.vae.num_wavenet_blocks),
                        ("dec", cfg.vae.decoder_blocks)):
            for i in range(n):
                b = tree[f"{side}_block_{i}"]
                path = f"/{side}_blocks/wave_net_res_block{_sfx(i)}"
                g[f"{path}/conv"] = _dense(b["conv"])
                g[f"{path}/film/proj"] = _dense(b["film"]["proj"])
                g[f"{path}/res_proj"] = _dense(b["res_proj"])
        for i in range(cfg.vae.down_stages):
            g[f"/downsample/blocks/conv1d{_sfx(i)}"] = _dense(
                tree["downsample"][f"conv_{i}"])
            g[f"/layers/temporal_upsample/refine/conv1d{_sfx(i)}"] = _dense(
                tree["upsample"][f"conv_{i}"])
        for i in range(cfg.vae.flow_layers):
            ap, path = (tree["vpflow"][f"ap_{i}"],
                        f"/flow/layers_list/ap_coupling{_sfx(i)}")
            g[f"{path}/cond_proj"] = _dense(ap["cond_proj"])
            g[f"{path}/film/proj"] = _dense(ap["film"]["proj"])
            g[f"{path}/net_pre"] = _dense(ap["net_pre"])
            g[f"{path}/net_post"] = _dense(ap["net_post"])
    else:  # the Keras vocoder
        h = cfg.hifigan
        g["/conv_pre"] = _dense(tree["conv_pre"])
        g["/conv_post"] = _dense(tree["conv_post"])
        nk = len(h.resblock_kernel_sizes)
        for i in range(len(h.upsample_rates)):
            up = tree[f"ups_{i}"]
            g[f"/layers/conv1d_transpose{_sfx(i)}"] = [
                np.transpose(up["kernel"], (0, 2, 1)), up["bias"]]
            for j in range(nk):
                n = i * nk + j
                rb = tree[f"resblocks_{n}"]
                for p in range(len(h.resblock_dilations[j])):
                    g[f"/layers/res_block{_sfx(n)}/convs1/conv1d{_sfx(p)}"] = \
                        _dense(rb[f"convs1_{p}"])
                    g[f"/layers/res_block{_sfx(n)}/convs2/conv1d{_sfx(p)}"] = \
                        _dense(rb[f"convs2_{p}"])
    return g


def _write_h5(path, groups):
    import h5py

    with h5py.File(path, "w") as f:
        for group, arrays in groups.items():
            for i, a in enumerate(arrays):
                f.create_dataset(f"{group}/vars/{i}", data=np.asarray(a))
    return path


def _jax_convert(stage, w, cfg):
    if stage == "encoder":
        return jkeras.convert_encoder(w, cfg.encoder.num_blocks)
    if stage == "duration":
        return jkeras.convert_duration(w, cfg.duration.num_layers)
    if stage == "postnet":
        return jkeras.convert_postnet(w, cfg.postnet.num_layers)
    if stage == "vae":
        v = cfg.vae
        return jkeras.convert_vae(w, v.num_wavenet_blocks, v.decoder_blocks,
                                  v.down_stages, v.flow_layers)
    h = cfg.hifigan
    return jkeras.convert_keras_vocoder(w, h.upsample_rates,
                                        h.resblock_kernel_sizes,
                                        h.resblock_dilations)


KERAS_STAGES = ("encoder", "duration", "postnet", "vae", "hifigan")


@pytest.fixture(scope="module")
def keras_fixture(tmp_path_factory):
    """Seeded stage trees (the JAX pipeline's init trees, every leaf
    perturbed; BatchNorm variances kept positive), their .weights.h5 files
    and the JAX pipeline."""
    from iris_tts_tpu.models.pipeline import TTSPipeline as JaxPipeline

    jpipe = JaxPipeline.initialize(small_config(), seed=0)
    cfg = jpipe.config  # the vocab's size
    rng = np.random.default_rng(0)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        noise = 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return a + np.abs(noise) + 0.5
        return a + noise

    root = tmp_path_factory.mktemp("keras")
    trees, files = {}, {}
    for stage in KERAS_STAGES:
        trees[stage] = jax.tree_util.tree_map_with_path(
            perturb, jpipe.params[stage])
        files[stage] = _write_h5(root / f"{stage}.weights.h5",
                                 _h5_groups(stage, trees[stage], cfg))
    return cfg, jpipe, trees, files


@pytest.mark.parametrize("stage", KERAS_STAGES)
def test_keras_stage_matches_jax(keras_fixture, stage):
    cfg, jpipe, trees, files = keras_fixture
    w = keras_h5.read_weights_h5(files[stage])
    # The fixture is the JAX converter's contract: it reads back the tree.
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           _jax_convert(stage, w, cfg), trees[stage])
    pcfg = port_config(cfg)
    rng = np.random.default_rng(1)
    from iris_tts_tpu.models import (
        DurationPredictor as JDur,
        HiFiGANGenerator as JGen,
        PhonemeEncoder as JEnc,
        PostNet as JPost,
        TextConditionedVAE as JVAE,
    )

    if stage == "encoder":
        sd = keras_h5.convert_encoder(w, pcfg.encoder.num_blocks)
        mod = PhonemeEncoder(pcfg.encoder)
        ids = rng.integers(1, pcfg.encoder.vocab_size, (2, 9))
        mask = np.ones((2, 9), bool)
        mask[1, 6:] = False
        want = JEnc(config=cfg.encoder).apply(
            {"params": trees[stage]}, jnp.asarray(ids), jnp.asarray(mask))
        args = (_t(ids).long(), _t(mask))
    elif stage == "duration":
        sd = keras_h5.convert_duration(w, pcfg.duration.num_layers)
        mod = DurationPredictor(pcfg.encoder.embed_dim, pcfg.duration)
        x = rng.standard_normal((2, 9, cfg.encoder.embed_dim)).astype(
            np.float32)
        want = JDur(config=cfg.duration).apply({"params": trees[stage]},
                                               jnp.asarray(x))
        args = (_t(x),)
    elif stage == "postnet":
        sd = keras_h5.convert_postnet(w, pcfg.postnet.num_layers)
        mod = PostNet(pcfg.postnet)
        mel = rng.standard_normal((2, 16, cfg.postnet.n_mels)).astype(
            np.float32)
        want = JPost(config=cfg.postnet).apply(trees[stage],
                                               jnp.asarray(mel))
        args = (_t(mel),)
    elif stage == "vae":
        sd = keras_h5.convert_vae(w, pcfg.vae.num_wavenet_blocks,
                                  pcfg.vae.decoder_blocks,
                                  pcfg.vae.down_stages, pcfg.vae.flow_layers)
        mod = TextConditionedVAE(pcfg.vae)
        t = 24
        cond = rng.standard_normal((2, t, cfg.vae.cond_dim)).astype(
            np.float32)
        z = rng.standard_normal(
            (2, t // cfg.vae.down_factor, cfg.vae.latent_dim)).astype(
            np.float32)
        want = JVAE(config=cfg.vae).apply(
            {"params": trees[stage]}, jnp.asarray(cond),
            z_prior=jnp.asarray(z), method=JVAE.generate)[0]
        mod.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = mod.eval().generate(_t(cond), z_prior=_t(z))[0]
        assert max_abs(got, want) <= 1e-5
        return
    else:
        h = pcfg.hifigan
        sd = keras_h5.convert_keras_vocoder(
            w, h.upsample_rates, h.resblock_kernel_sizes,
            h.resblock_dilations)
        mod = HiFiGANGenerator(h)
        mel = rng.standard_normal((2, 10, h.in_channels)).astype(np.float32)
        want = JGen(config=cfg.hifigan).apply({"params": trees[stage]},
                                              jnp.asarray(mel))
        args = (_t(mel),)
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = mod.eval()(*args)
    assert max_abs(got, want) <= 1e-5


def test_keras_reference_attention_layout_converts_alike(keras_fixture,
                                                         tmp_path):
    """The reference's attention projections are Dense [E, E] kernels and
    [E] biases, not flax's [E, H, D]: the port lays both out as the same
    encoder."""
    cfg, _, trees, _ = keras_fixture
    flat = jax.tree_util.tree_map(np.asarray, trees["encoder"])
    for i in range(cfg.encoder.num_blocks):
        att = flat[f"block_{i}"]["attention"]
        for name in ("query", "key", "value"):
            k = att[name]["kernel"]
            att[name] = {"kernel": k.reshape(k.shape[0], -1),
                         "bias": att[name]["bias"].reshape(-1)}
        k = att["out"]["kernel"]
        att["out"] = {"kernel": k.reshape(-1, k.shape[-1]),
                      "bias": att["out"]["bias"]}
    path = _write_h5(tmp_path / "enc2d.weights.h5",
                     _h5_groups("encoder", flat, cfg))
    got = keras_h5.convert_encoder(keras_h5.read_weights_h5(path),
                                   cfg.encoder.num_blocks)
    want = module_state_from_jax(jax.tree_util.tree_map(
        np.asarray, trees["encoder"]))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_load_keras_stage_weights_drives_a_pipeline(keras_fixture):
    cfg, _, _, files = keras_fixture
    pcfg = port_config(cfg)
    converted = keras_h5.load_keras_stage_weights(
        pcfg, encoder_path=files["encoder"], duration_path=files["duration"],
        vae_path=files["vae"], postnet_path=files["postnet"],
        vocoder_path=files["hifigan"])
    assert set(converted) == set(KERAS_STAGES)
    pipe = TTSPipeline.initialize(pcfg, seed=0, device="cpu")
    for name, sd in converted.items():
        getattr(pipe.model, name).load_state_dict(sd, strict=True)
    audio = pipe.synthesize("hello world", seed=0)
    assert audio.ndim == 1 and len(audio) > 0 and np.isfinite(audio).all()


def test_import_keras_checkpoint_end_to_end(keras_fixture, tmp_path):
    from iris_tts_tpu_torch.config import save_config
    from iris_tts_tpu_torch.scripts import import_keras_checkpoint

    cfg, _, _, files = keras_fixture
    pcfg = port_config(cfg)
    save_config(pcfg, tmp_path / "config.json")
    out = tmp_path / "exported"
    import_keras_checkpoint.main([
        "--output", str(out), "--config", str(tmp_path / "config.json"),
        "--encoder_weights", str(files["encoder"]),
        "--duration_weights", str(files["duration"]),
        "--postnet_weights", str(files["postnet"]),
        "--device", "cpu"])
    pipe = TTSPipeline.load(out, device="cpu")
    want = keras_h5.convert_duration(
        keras_h5.read_weights_h5(files["duration"]), pcfg.duration.num_layers)
    for k, v in want.items():
        assert torch.equal(pipe.model.duration.state_dict()[k], v), k
    audio = pipe.synthesize("hello world", seed=0)
    assert audio.ndim == 1 and np.isfinite(audio).all()
    # A config that does not fit the file: the shapes are checked.
    from dataclasses import replace

    save_config(replace(pcfg, encoder=replace(pcfg.encoder, embed_dim=64)),
                tmp_path / "wide.json")
    with pytest.raises(SystemExit, match="do not match"):
        import_keras_checkpoint.main([
            "--output", str(tmp_path / "bad"), "--device", "cpu",
            "--config", str(tmp_path / "wide.json"),
            "--encoder_weights", str(files["encoder"])])


# ---------------------------------------------------------------------------
# Scripts
# ---------------------------------------------------------------------------


def test_verify_reference_artifacts_dry_run(tmp_path):
    """The JAX package's dry run (a seeded generator checkpoint and a mini
    corpus), written to a report in ``tmp_path``."""
    from corpus_utils import build_mini_corpus
    from iris_tts_tpu_torch.config import (
        EncoderConfig,
        PostNetConfig,
        VAEConfig,
        save_config,
    )
    from iris_tts_tpu_torch.scripts import verify_reference_artifacts

    cfg = IrisConfig(
        encoder=EncoderConfig(vocab_size=16, embed_dim=32, num_blocks=1,
                              num_heads=2),
        vae=VAEConfig(cond_dim=32, model_channels=16, latent_dim=4,
                      num_wavenet_blocks=1, decoder_blocks=1, flow_layers=1,
                      flow_hidden=8),
        postnet=PostNetConfig(num_layers=2, channels=16),
        hifigan=HiFiGANConfig(in_channels=10, upsample_rates=(4, 2),
                              upsample_kernel_sizes=(8, 4),
                              upsample_initial_channel=32,
                              resblock_kernel_sizes=(3,),
                              resblock_dilations=((1, 3),)),
    )
    save_config(cfg, tmp_path / "cfg.json")
    torch.manual_seed(3)
    ckpt = tmp_path / "generator.ckpt"
    torch.save(TorchGenerator(cfg.hifigan).state_dict(), ckpt)
    corpus_root, align_dir = build_mini_corpus(tmp_path / "data", n=24)
    report = tmp_path / "PARITY_dryrun.md"
    rc = verify_reference_artifacts.main([
        "--hifigan_ckpt", str(ckpt), "--ljspeech", str(corpus_root),
        "--alignment_dir", str(align_dir),
        "--cache_dir", str(tmp_path / "cache"),
        "--config", str(tmp_path / "cfg.json"), "--parity_md", str(report),
        "--device", "cpu"])
    text = report.read_text()
    assert rc == 0, text
    assert "ALL PASS" in text and "hifigan waveform parity" in text
    assert "LJSpeech VAE epoch" in text


def test_hifigan_integration_exits_zero(capsys):
    from iris_tts_tpu_torch.scripts import hifigan_integration

    assert hifigan_integration.main(["--device", "cpu"]) == 0
    assert "ALL CHECKS PASSED" in capsys.readouterr().out


def test_demo_vocoder_writes_a_wav(tmp_path):
    from iris_tts_tpu_torch.data.audio_io import read_wav
    from iris_tts_tpu_torch.scripts import demo_vocoder

    out = tmp_path / "demo.wav"
    wav = demo_vocoder.main(["--output_wav", str(out), "--device", "cpu"])
    audio, sr = read_wav(out)
    assert sr == 22050 and len(audio) == len(wav) == 87 * 256
    assert np.isfinite(audio).all()


def test_gan_stage_starts_from_a_torch_generator(tmp_path):
    """``train_hifigan --init_from_torch``: the GAN stage's generator (and
    its EMA copy) start from the converted checkpoint."""
    from corpus_utils import build_mini_corpus
    from iris_tts_tpu_torch.scripts import train_hifigan
    from iris_tts_tpu_torch.train import stages

    args = train_hifigan.build_parser().parse_args(["--init_from_torch", "g"])
    assert args.init_from_torch == "g"
    cfg = port_config(small_config())
    torch.manual_seed(6)
    path = tmp_path / "generator.ckpt"
    torch.save({"generator": TorchGenerator(cfg.hifigan).state_dict()}, path)
    corpus_root, align_dir = build_mini_corpus(tmp_path / "data", n=4)
    loop = stages.gan_stage(cfg, corpus_root, align_dir, tmp_path / "out",
                            device="cpu", disc_width=0.25, ema_decay=0.9,
                            init_from_torch=path)
    want = hifigan_torch.convert_hifigan_state_dict(
        hifigan_torch.load_torch_checkpoint(path), cfg.hifigan)
    for module in (loop.state.gen.params, loop.state.gen.ema_params):
        got = module.state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_synthesize_script_takes_a_torch_hifigan(tmp_path):
    from iris_tts_tpu_torch.config import save_config
    from iris_tts_tpu_torch.scripts import synthesize

    cfg = _arpabet_config()
    enc_dir, vae_dir = _stage_checkpoints(tmp_path, cfg)
    save_config(cfg, tmp_path / "cfg.json")
    torch.manual_seed(8)
    path = tmp_path / "generator.ckpt"
    torch.save(TorchGenerator(cfg.hifigan).state_dict(), path)
    from iris_tts_tpu_torch.scripts import batch_synthesize

    args = batch_synthesize.build_parser().parse_args(
        ["--hifigan_checkpoint", str(path)])
    assert args.hifigan_checkpoint == str(path)
    out = tmp_path / "out.wav"
    audio = synthesize.main([
        "--text", "Hello world.", "--encoder_checkpoint", str(enc_dir),
        "--vae_checkpoint", str(vae_dir), "--hifigan_checkpoint", str(path),
        "--output_wav", str(out), "--device", "cpu"])
    assert out.exists() and audio.ndim == 1 and np.isfinite(audio).all()
