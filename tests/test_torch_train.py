"""Port parity of the training slice's models and steps against the JAX
package, on the CPU at a tiny width.

Tolerances: forward passes in train mode with dropout 0 ≤ 1e-5; losses
≤ 1e-6 relative; gradients ≤ 1e-4 of the largest |g|; params after three
optimizer steps with schedule and clipping ≤ 1e-6 abs; BatchNorm running
statistics after one step ≤ 1e-6. Dropout masks and the VAE's ε cannot
match across frameworks: those paths are compared with dropout 0 and the
VAE at its posterior mean, and the noise path is checked on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import iris_tts_tpu.config as jcfg
import iris_tts_tpu.ops.losses as jlosses
import iris_tts_tpu.train.schedules as jsched
import iris_tts_tpu_torch.config as tcfg
from iris_tts_tpu.models.discriminators import (
    HiFiGANDiscriminators as JDisc,
)
from iris_tts_tpu.models.encoder import DurationPredictor as JDur
from iris_tts_tpu.models.encoder import PhonemeEncoder as JEnc
from iris_tts_tpu.models.hifigan import HiFiGANGenerator as JGen
from iris_tts_tpu.models.postnet import PostNet as JPostNet
from iris_tts_tpu.models.vae import TextConditionedVAE as JVAE
from iris_tts_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from iris_tts_tpu.train.state import TrainState as JState
from iris_tts_tpu.train.state import adam_clipped as jax_adam_clipped
from iris_tts_tpu.train.steps import (
    make_duration_eval_step as jax_duration_eval,
    make_duration_train_step as jax_duration_step,
    make_postnet_train_step as jax_postnet_step,
    make_vae_eval_step as jax_vae_eval,
    make_vae_recon_step as jax_vae_recon,
)
from iris_tts_tpu_torch.convert.from_jax import (
    load_train_state_from_jax,
    module_state_from_jax,
)
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import dropout, init_params
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE, reparameterize
from iris_tts_tpu_torch.train import schedules
from iris_tts_tpu_torch.train.gan import disc_loss, gen_loss, make_gan_steps
from iris_tts_tpu_torch.train.state import (
    TrainState,
    adam_clipped,
    clip_by_global_norm_,
)
from iris_tts_tpu_torch.train.steps import (
    duration_loss,
    make_duration_eval_step,
    make_duration_train_step,
    make_postnet_train_step,
    make_vae_eval_step,
    make_vae_recon_step,
    make_vae_train_step,
    postnet_stage_loss,
    vae_stage_loss,
)
from tests.torch_port_utils import max_abs, numpy_tree

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
B, P, T = 3, 7, 32


def tiny_config(m, **vae):
    """One or two layers, narrow channels, dropout 0 everywhere."""
    return m.IrisConfig(
        encoder=m.EncoderConfig(vocab_size=12, embed_dim=16, num_blocks=2,
                                num_heads=2, dropout=0.0),
        duration=m.DurationConfig(hidden_dim=8, num_layers=2, dropout=0.0),
        vae=m.VAEConfig(n_mels=8, cond_dim=16, model_channels=8,
                        latent_dim=4, num_wavenet_blocks=2,
                        decoder_blocks=1, flow_layers=2, flow_hidden=8,
                        dropout=0.0, **vae),
        postnet=m.PostNetConfig(n_mels=8, num_layers=3, channels=8,
                                dropout=0.0),
        hifigan=m.HiFiGANConfig(upsample_initial_channel=16,
                                resblock_kernel_sizes=(3,),
                                resblock_dilations=((1, 3),)),
    )


JCFG, CFG = tiny_config(jcfg), tiny_config(tcfg)


def _batch(seed=0, n_mels=8):
    rng = np.random.default_rng(seed)
    mask = (np.arange(P)[None] < np.array([[P], [5], [3]])).astype(np.float32)
    return {
        "phoneme_ids": (rng.integers(2, 12, (B, P)) * mask).astype(np.int32),
        "durations": (rng.integers(1, 5, (B, P)) * mask).astype(np.float32),
        "phoneme_mask": mask,
        "mel": rng.standard_normal((B, T, n_mels)).astype(np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(a, b):
    a = float(a.detach()) if isinstance(a, torch.Tensor) else float(a)
    return abs(a - float(b)) / max(abs(float(b)), 1e-30)


def assert_grads_match(module: nn.Module, jax_grads):
    """Port ``.grad`` against the JAX gradient tree, ≤1e-4 of max |g| (a
    parameter the loss does not read has no ``.grad`` here and a zero
    gradient in JAX)."""
    want = module_state_from_jax(numpy_tree(jax_grads))
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in module.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0
    worst = max(max_abs(got[k], want[k]) for k in want)
    assert worst <= 1e-4 * scale, (worst, scale)


def zero_grad_keys(module: nn.Module):
    """Parameters whose true gradient is zero: attention key biases (a
    constant per query row, which softmax takes out) and the bias of a conv
    that a BatchNorm follows (the batch mean takes it out) — with that
    BatchNorm's running mean, which follows the bias."""
    keys = {k for k, _ in module.named_parameters()}
    out = {k for k in keys if k.endswith("attention.key.bias")}
    for k in keys:
        bn = k.replace("conv", "bn").replace(".bias", ".weight")
        if k.endswith(".bias") and k.split(".")[-2].startswith("conv") and (
                bn in keys):
            out |= {k, bn.replace(".weight", ".running_mean")}
    return out


def assert_params_match(module: nn.Module, jax_params, batch_stats=None,
                        atol=1e-6, lr_steps=0.0):
    """Params (and statistics) against JAX's, ≤ ``atol``. The parameters of
    :func:`zero_grad_keys` get rounding-level gradients, which Adam turns
    into steps of up to lr, so the two packages move them differently; they
    change no output, and are held to the most two such walks can part:
    2 × ``lr_steps`` (the sum of the learning rates of the steps taken)."""
    noise_grads = zero_grad_keys(module)
    want = module_state_from_jax(numpy_tree(jax_params),
                                 None if batch_stats is None
                                 else numpy_tree(batch_stats))
    got = module.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            tol = 2 * lr_steps if k in noise_grads else atol
            assert max_abs(got[k], v) <= tol, k


def _port(module: nn.Module, jax_params, batch_stats=None):
    module.load_state_dict(module_state_from_jax(
        numpy_tree(jax_params),
        None if batch_stats is None else numpy_tree(batch_stats)),
        strict=True)
    return module


# -- fixtures: JAX params of each module, made once --------------------------


@pytest.fixture(scope="module")
def jax_params():
    ids = jnp.zeros((1, P), jnp.int32)
    enc = jax.jit(JEnc(config=JCFG.encoder).init)(KEY, ids)["params"]
    dur = jax.jit(JDur(config=JCFG.duration).init)(
        KEY, jnp.zeros((1, P, 16)))["params"]
    vae = jax.jit(JVAE(config=JCFG.vae).init)(
        {"params": KEY, "sample": KEY}, jnp.zeros((1, T, 8)),
        jnp.zeros((1, T, 16)))["params"]
    pn = jax.jit(JPostNet(config=JCFG.postnet).init)(
        KEY, jnp.zeros((1, T, 8)))
    # Non-trivial weights where flax initialises to zero or to 1/0 (the
    # logvar head, the couplings' output convs, the BatchNorm scale/bias
    # and statistics), so every path carries signal.
    rng = np.random.default_rng(3)
    bump = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape).astype(np.float32), t)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + 0.3 * rng.standard_normal(
            a.shape).astype(np.float32)), pn["batch_stats"])
    return {"encoder": bump(enc), "duration": bump(dur), "vae": bump(vae),
            "postnet": bump(pn["params"]), "postnet_stats": stats}


# -- train-mode forwards -------------------------------------------------------


def test_encoder_and_duration_train_forward_match_jax(jax_params):
    b = _batch()
    enc_j = JEnc(config=JCFG.encoder).apply(
        {"params": jax_params["encoder"]}, b["phoneme_ids"],
        padding_mask=b["phoneme_mask"], deterministic=False,
        rngs={"dropout": KEY})
    dur_j = JDur(config=JCFG.duration).apply(
        {"params": jax_params["duration"]}, enc_j, deterministic=False,
        rngs={"dropout": KEY})
    enc = _port(PhonemeEncoder(CFG.encoder), jax_params["encoder"])
    dur = _port(DurationPredictor(16, CFG.duration), jax_params["duration"])
    g = torch.Generator().manual_seed(0)
    tb = _t(b)
    with torch.no_grad():
        e = enc(tb["phoneme_ids"], tb["phoneme_mask"], deterministic=False,
                generator=g)
        d = dur(e, deterministic=False, generator=g)
    assert max_abs(e, enc_j) <= 1e-5
    assert max_abs(d, dur_j) <= 1e-5


def test_dropout_semantics():
    g = torch.Generator().manual_seed(1)
    x = torch.ones(200, 300)
    y = dropout(x, 0.3, False, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert dropout(x, 0.3, True, g) is x and dropout(x, 0.0, False, g) is x
    y1 = dropout(x, 0.5, False, torch.Generator().manual_seed(7))
    y2 = dropout(x, 0.5, False, torch.Generator().manual_seed(7))
    assert torch.equal(y1, y2)
    z = dropout(torch.ones(4, 2, 5, 5), 0.5, False, g, broadcast_dims=(0, 1))
    assert all(torch.equal(z[0, 0], z[i, j]) for i in range(4)
               for j in range(2))
    # Train mode with dropout on differs from eval and replays by seed.
    cfg = dataclasses.replace(CFG.encoder, dropout=0.3)
    enc = PhonemeEncoder(cfg)
    init_params(enc, torch.Generator().manual_seed(0))
    ids = torch.randint(2, 12, (2, 6), generator=g)
    mask = torch.ones(2, 6)
    ev = enc(ids, mask)
    tr = [enc(ids, mask, False, torch.Generator().manual_seed(5))
          for _ in range(2)]
    assert torch.equal(tr[0], tr[1]) and not torch.allclose(tr[0], ev)


@pytest.mark.parametrize("flow_prior", [False, True])
def test_vae_forward_matches_jax(jax_params, flow_prior):
    """Posterior mean path (deterministic) of the training forward, with
    u = flow(z)."""
    b = _batch()
    cond = np.random.default_rng(4).standard_normal((B, T, 16)).astype(
        np.float32)
    jcfg_v = dataclasses.replace(JCFG.vae, flow_prior=flow_prior)
    out_j = JVAE(config=jcfg_v).apply({"params": jax_params["vae"]},
                                      b["mel"], cond, return_u=True)
    vae = _port(TextConditionedVAE(dataclasses.replace(
        CFG.vae, flow_prior=flow_prior)), jax_params["vae"])
    with torch.no_grad():
        out = vae(torch.from_numpy(b["mel"]), torch.from_numpy(cond),
                  return_u=True)
    for got, want in [(out[0], out_j[0]), (out[1][0], out_j[1][0]),
                      (out[1][1], out_j[1][1]), (out[2], out_j[2]),
                      (out[3], out_j[3])]:
        assert max_abs(got, want) <= 1e-5


def test_vae_noise_path():
    """For an ε passed in, z = μ + exp(logvar/2)·ε exactly, and ε = 0 is the
    posterior-mean path."""
    vae = TextConditionedVAE(CFG.vae)
    init_params(vae, torch.Generator().manual_seed(0))
    nn.init.normal_(vae.latent_logvar_proj.weight, 0, 0.3)
    mel, cond = torch.randn(2, T, 8), torch.randn(2, T, 16)
    eps = torch.randn(2, T // 4, 4)
    with torch.no_grad():
        mean_out = vae(mel, cond)
        zero = vae(mel, cond, deterministic=False, eps=torch.zeros_like(eps))
        noisy = vae(mel, cond, deterministic=False, eps=eps, return_u=True)
        mean, logvar = noisy[1]
        z = reparameterize(mean, logvar, eps)
        lat_cond = vae.latent_cond(cond.transpose(1, 2))
        u = vae.vpflow(z.transpose(1, 2), lat_cond)
        recon, _ = vae.decode(u, lat_cond)
    assert torch.equal(zero[0], mean_out[0])
    assert torch.equal(z, mean + torch.exp(0.5 * logvar) * eps)
    assert torch.equal(noisy[3], u.transpose(1, 2))
    assert torch.equal(noisy[0], recon.transpose(1, 2))
    np.testing.assert_allclose(
        z.numpy(), np.asarray(mean.numpy() + jnp.exp(0.5 * logvar.numpy())
                              * eps.numpy()), rtol=1e-6, atol=1e-7)
    g = torch.Generator().manual_seed(9)
    a = vae(mel, cond, deterministic=False, generator=g)[0]
    assert not torch.allclose(a, mean_out[0])


def test_postnet_batch_statistics_match_jax(jax_params):
    """Train-mode PostNet: output ≤1e-5 and the running statistics after
    one step ≤1e-6, by flax's update rule (biased batch variance)."""
    mel = _batch()["mel"]
    out_j, upd = JPostNet(config=JCFG.postnet).apply(
        {"params": jax_params["postnet"],
         "batch_stats": jax_params["postnet_stats"]},
        mel, deterministic=False, use_running_average=False,
        mutable=["batch_stats"], rngs={"dropout": KEY})
    pn = _port(PostNet(CFG.postnet), jax_params["postnet"],
               jax_params["postnet_stats"])
    with torch.no_grad():
        out = pn(torch.from_numpy(mel), deterministic=False,
                 use_running_average=False)
    assert max_abs(out, out_j) <= 1e-5
    want = module_state_from_jax(jax_params["postnet"],
                                 numpy_tree(upd["batch_stats"]))
    for k, v in pn.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert max_abs(v, want[k]) <= 1e-6, k
    # Inference mode reads the (updated) running statistics.
    out_inf_j = JPostNet(config=JCFG.postnet).apply(
        {"params": jax_params["postnet"], "batch_stats": upd["batch_stats"]},
        mel)
    with torch.no_grad():
        assert max_abs(pn(torch.from_numpy(mel)), out_inf_j) <= 1e-5


def test_discriminators_match_jax():
    """MPD (edge padding to the period) and MSD (SAME padding, grouped
    strided convs, zero-padded pooling) at width 0.125 on a length that is
    a multiple of no period; every JAX leaf lands in one torch key."""
    audio = (0.3 * np.random.default_rng(5).standard_normal((2, 1999))
             ).astype(np.float32)
    jd = JDisc(width=0.125)
    params = jax.jit(jd.init)(KEY, jnp.zeros((2, 1999)))["params"]
    logits_j, feats_j = jax.jit(jd.apply)({"params": params}, audio)
    disc = HiFiGANDiscriminators(width=0.125)
    sd = module_state_from_jax(numpy_tree(params), module=disc)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    disc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        logits, feats = disc(torch.from_numpy(audio))
    assert len(logits) == len(logits_j) == 8
    for got, want in zip(logits, logits_j):
        assert max_abs(got, want) <= 1e-5
    for fs, fjs in zip(feats, feats_j):
        for f, fj in zip(fs, fjs):
            # port: channels first; JAX: channels last
            f = f.movedim(1, -1)
            assert max_abs(f, fj) <= 1e-5
    params["mpd"]["period_2"]["stray"] = {"bias": np.zeros(1, np.float32)}
    with pytest.raises(ValueError):
        module_state_from_jax(numpy_tree(params), module=disc)


# -- schedules and the optimizer -----------------------------------------------


@pytest.mark.parametrize("which", ["cosine", "exponential"])
def test_schedules_match_optax(which):
    if which == "cosine":
        got = schedules.warmup_cosine(3e-4, 7, 60, 0.05)
        want = jsched.warmup_cosine(3e-4, 7, 60, 0.05)
    else:
        got = schedules.warmup_exponential(3e-4, 7, 0.9, 11)
        want = jsched.warmup_exponential(3e-4, 7, 0.9, 11)
    for step in range(80):
        assert _rel(got(step), want(step)) <= 1e-6, step
    for epoch in (-1, 0, 3, 20, 25):
        assert schedules.kl_weight_schedule(epoch, 1e-3, 1e-2, 20) == \
            jsched.kl_weight_schedule(epoch, 1e-3, 1e-2, 20)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(6)
    grads = [scale * rng.standard_normal(s).astype(np.float32)
             for s in [(3, 4), (5,)]]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, 1.0)
    for g, w in zip(got, want):
        assert max_abs(g, w) <= 1e-7


@pytest.mark.parametrize("weight_decay,ema", [(0.0, None), (0.05, 0.9)])
def test_optimizer_three_steps_match_optax(weight_decay, ema):
    """Adam/AdamW with a warmup-cosine schedule, global-norm clipping (on
    for two of the three steps) and EMA: params ≤1e-6 abs after 3 steps."""
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    b0 = rng.standard_normal(4).astype(np.float32)
    grads = [(s * rng.standard_normal((4, 3)).astype(np.float32),
              s * rng.standard_normal(4).astype(np.float32))
             for s in (3.0, 0.05, 2.0)]
    lr = jsched.warmup_cosine(0.01, 2, 10)
    js = JState.create({"kernel": jnp.asarray(w0.T), "bias": jnp.asarray(b0)},
                       jax_adam_clipped(lr, 1.0, weight_decay), KEY,
                       ema_decay=ema)
    lin = nn.Linear(3, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0))
        lin.bias.copy_(torch.from_numpy(b0))
    ts = TrainState.create(lin, adam_clipped(schedules.warmup_cosine(
        0.01, 2, 10), 1.0, weight_decay), 0, ema_decay=ema)
    for gw, gb in grads:
        js = js.apply_gradients({"kernel": jnp.asarray(gw.T),
                                 "bias": jnp.asarray(gb)})
        lin.weight.grad = torch.from_numpy(gw.copy())
        lin.bias.grad = torch.from_numpy(gb.copy())
        ts.apply_gradients()
    assert ts.step == int(js.step) == 3
    assert max_abs(lin.weight, np.asarray(js.params["kernel"]).T) <= 1e-6
    assert max_abs(lin.bias, js.params["bias"]) <= 1e-6
    if ema:
        assert max_abs(ts.ema_params.weight,
                       np.asarray(js.ema_params["kernel"]).T) <= 1e-6
    assert lin.weight.grad is None


# -- stage steps -------------------------------------------------------------


def _jax_state(params, lr, **kw):
    return JState.create(params, jax_adam_clipped(lr, 1.0), KEY, **kw)


def _port_state(module, lr, **kw):
    return TrainState.create(module, adam_clipped(lr, 1.0), 0, **kw)


def test_duration_stage_matches_jax(jax_params):
    """Loss and gradients of the duration loss, then three train steps
    (warmup-cosine schedule, clipping): the first step's loss and the
    params after three; the eval step's metrics. Later steps' losses are
    held to 1e-5: XLA's compiled step differs from its own op-by-op
    evaluation by ~3e-6 there."""
    lr = jsched.warmup_cosine(1e-3, 2, 10)
    params = {"encoder": jax_params["encoder"],
              "duration": jax_params["duration"]}
    module = nn.ModuleDict({
        "encoder": PhonemeEncoder(CFG.encoder),
        "duration": DurationPredictor(16, CFG.duration)})
    _port(module, params)

    def jloss(p, batch):
        enc = JEnc(config=JCFG.encoder).apply(
            {"params": p["encoder"]}, batch["phoneme_ids"],
            padding_mask=batch["phoneme_mask"])
        pred = JDur(config=JCFG.duration).apply({"params": p["duration"]},
                                                enc)
        return jlosses.duration_huber_loss(pred, batch["durations"],
                                           batch["phoneme_mask"], 10.0)

    b0 = _batch(0)
    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(params, _j(b0))
    loss, _ = duration_loss(module, _t(b0), CFG, deterministic=True)
    loss.backward()
    assert _rel(loss, jval) <= 1e-6
    assert_grads_match(module, jgrad)
    module.zero_grad(set_to_none=True)
    jm = jax_duration_eval(JCFG)(params, _j(_batch(5)))
    m = make_duration_eval_step(CFG)(module, _t(_batch(5)))
    assert set(m) == set(jm)
    for k in jm:
        assert _rel(m[k], jm[k]) <= 1e-6

    js = _jax_state(params, lr)
    ts = _port_state(module, schedules.warmup_cosine(1e-3, 2, 10))
    jstep = jax.jit(jax_duration_step(JCFG))
    step = make_duration_train_step(CFG)
    for i in range(3):
        b = _batch(i)
        js, jm = jstep(js, _j(b))
        ts, m = step(ts, _t(b))
        assert _rel(m["duration_loss"], jm["duration_loss"]) <= (
            1e-6 if i == 0 else 1e-5)
    assert_params_match(module, js.params,
                        lr_steps=sum(lr(i) for i in range(3)))


def test_accumulated_step_matches_jax(jax_params):
    """accum_steps=2: one update from the mean of two microbatch
    gradients."""
    from iris_tts_tpu.train.steps import split_microbatches as jsplit
    from iris_tts_tpu_torch.train.steps import split_microbatches

    params = {"encoder": jax_params["encoder"],
              "duration": jax_params["duration"]}
    module = _port(nn.ModuleDict({
        "encoder": PhonemeEncoder(CFG.encoder),
        "duration": DurationPredictor(16, CFG.duration)}), params)
    b = {k: np.concatenate([v, w]) for (k, v), w in
         zip(_batch(1).items(), _batch(2).values())}
    b.pop("mel")
    js, jm = jax.jit(jax_duration_step(JCFG, accum_steps=2))(
        _jax_state(params, 1e-3), _j(jsplit(b, 2)))
    ts, m = make_duration_train_step(CFG, accum_steps=2)(
        _port_state(module, 1e-3), _t(split_microbatches(b, 2)))
    assert _rel(m["duration_loss"], jm["duration_loss"]) <= 1e-6
    assert_params_match(module, js.params, lr_steps=1e-3)


@pytest.mark.parametrize("flow_prior", [False, True])
def test_vae_stage_matches_jax(jax_params, flow_prior):
    """The VAE stage's loss at the posterior mean (eval step) and its
    gradient; the train step runs, draws its noise from the state's
    generator and updates the params."""
    jc = dataclasses.replace(JCFG, vae=dataclasses.replace(
        JCFG.vae, flow_prior=flow_prior))
    tc = dataclasses.replace(CFG, vae=dataclasses.replace(
        CFG.vae, flow_prior=flow_prior))
    frozen_j = {"encoder": jax_params["encoder"]}
    encoder = _port(PhonemeEncoder(CFG.encoder), jax_params["encoder"])
    vae = _port(TextConditionedVAE(tc.vae), jax_params["vae"])
    b = _batch(3)
    kl_weight = 0.5
    jeval = jax_vae_eval(jc)

    def jloss(p):
        return jeval(p, frozen_j, _j(b), kl_weight)["total"]

    jm = jeval(jax_params["vae"], frozen_j, _j(b), kl_weight)
    jgrad = jax.jit(jax.grad(jloss))(jax_params["vae"])
    frozen = nn.ModuleDict({"encoder": encoder})
    m = make_vae_eval_step(tc)(vae, frozen, _t(b), kl_weight)
    for k in ("recon_l1", "kl", "total"):
        assert _rel(m[k], jm[k]) <= 1e-6, k
    recon_j, mask_j = jax_vae_recon(jc)(jax_params["vae"], frozen_j, _j(b))
    recon, mask = make_vae_recon_step(tc)(vae, frozen, _t(b))
    assert max_abs(recon, recon_j) <= 1e-5 and max_abs(mask, mask_j) == 0
    loss, _ = vae_stage_loss(vae, frozen, _t(b), kl_weight, tc,
                             deterministic=True)
    loss.backward()
    assert_grads_match(vae, jgrad)
    vae.zero_grad(set_to_none=True)

    state = _port_state(vae, 1e-3, frozen={"encoder": encoder})
    before = {k: v.clone() for k, v in vae.state_dict().items()}
    g0 = state.generator.get_state()
    state, m = make_vae_train_step(tc)(state, _t(b), kl_weight)
    assert state.step == 1 and torch.isfinite(m["total"])
    assert not torch.equal(state.generator.get_state(), g0)
    assert any(not torch.equal(v, vae.state_dict()[k])
               for k, v in before.items())
    assert all(not p.requires_grad for p in state.frozen.parameters())


def test_postnet_stage_matches_jax(jax_params):
    """Loss, gradients and batch statistics of the first step, then params
    and statistics after three steps (dropout 0; later losses ≤1e-5 as in
    the duration stage)."""
    frozen_j = {"encoder": jax_params["encoder"], "vae": jax_params["vae"]}
    pn = _port(PostNet(CFG.postnet), jax_params["postnet"],
               jax_params["postnet_stats"])
    frozen = {"encoder": _port(PhonemeEncoder(CFG.encoder),
                               jax_params["encoder"]),
              "vae": _port(TextConditionedVAE(CFG.vae), jax_params["vae"])}
    js = _jax_state(jax_params["postnet"], 1e-3,
                    batch_stats=jax_params["postnet_stats"], frozen=frozen_j)
    ts = _port_state(pn, 1e-3, frozen=frozen)
    jstep = jax.jit(jax_postnet_step(JCFG))
    step = make_postnet_train_step(CFG)
    for i in range(3):
        b = _batch(10 + i)
        if i == 0:
            jgrad = jax.jit(jax.grad(_jax_postnet_loss))(
                js.params, js.batch_stats, frozen_j, b)
            loss, _ = postnet_stage_loss(pn, ts.frozen, _t(b),
                                         deterministic=True)
            loss.backward()
            assert_grads_match(pn, jgrad)
            pn.zero_grad(set_to_none=True)
            with torch.no_grad():  # undo that forward's statistics update
                pn.load_state_dict(module_state_from_jax(
                    numpy_tree(js.params), numpy_tree(js.batch_stats)))
        js, jm = jstep(js, _j(b))
        ts, m = step(ts, _t(b))
        assert _rel(m["postnet_l1"], jm["postnet_l1"]) <= (
            1e-6 if i == 0 else 1e-5)
        if i == 0:
            assert_params_match(pn, js.params, js.batch_stats,
                                lr_steps=1e-3)
            want = module_state_from_jax(numpy_tree(js.params),
                                         numpy_tree(js.batch_stats))
            for k in ts.batch_stats:
                assert max_abs(ts.batch_stats[k], want[k]) <= 1e-6, k
    assert_params_match(pn, js.params, js.batch_stats, lr_steps=3e-3)
    assert set(ts.batch_stats) == {k for k in pn.state_dict()
                                   if k.endswith(("mean", "var"))}


def _jax_postnet_loss(params, batch_stats, frozen, b):
    from iris_tts_tpu.train.steps import _frame_condition

    jb = _j(b)
    cond, frame_mask = _frame_condition(JEnc(config=JCFG.encoder), frozen, jb)
    recon = JVAE(config=JCFG.vae).apply({"params": frozen["vae"]}, jb["mel"],
                                        cond)[0]
    refined, _ = JPostNet(config=JCFG.postnet).apply(
        {"params": params, "batch_stats": batch_stats}, recon,
        deterministic=True, use_running_average=False,
        mutable=["batch_stats"])
    return jlosses.masked_l1_loss(jb["mel"], refined, frame_mask)


# -- GAN ----------------------------------------------------------------------


GAN_CFG = tiny_config(tcfg)
JGAN_CFG = tiny_config(jcfg)


@pytest.fixture(scope="module")
def gan_setup():
    n_mels = JGAN_CFG.hifigan.in_channels
    rng = np.random.default_rng(8)
    batch = {"mel": rng.standard_normal((2, 8, n_mels)).astype(np.float32),
             "audio": (0.3 * rng.standard_normal((2, 8 * 256))).astype(
                 np.float32)}
    jg, jd = JGen(config=JGAN_CFG.hifigan), JDisc(width=0.125)
    k1, k2 = jax.random.split(KEY)
    gp = jax.jit(jg.init)(k1, jnp.zeros((1, 8, n_mels)))["params"]
    # Scale HiFiGAN's normal(0.01) kernels so the fake audio is not ~0.
    gp = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) * (8.0 if p[-1].key == "kernel" else 1.0),
        gp)
    dp = jax.jit(jd.init)(k2, jnp.zeros((2, 8 * 256)))["params"]
    return batch, jg, jd, numpy_tree(gp), numpy_tree(dp)


def test_gan_losses_and_gradients_match_jax(gan_setup):
    """Discriminator and generator losses and gradients (λ_fm = 2,
    λ_mel = 45, mel through the differentiable path)."""
    batch, jg, jd, gp, dp = gan_setup
    acfg = JGAN_CFG.audio

    def jdisc_loss(d, g, b):
        fake = jax.lax.stop_gradient(jg.apply({"params": g}, b["mel"]))
        real, _ = jd.apply({"params": d}, b["audio"])
        fk, _ = jd.apply({"params": d}, fake)
        return jlosses.lsgan_discriminator_loss(real, fk)

    def jgen_loss(g, d, b):
        fake = jg.apply({"params": g}, b["mel"])
        fk, ff = jd.apply({"params": d}, fake)
        _, rf = jd.apply({"params": d}, b["audio"])
        mel_l1 = jnp.mean(jnp.abs(jax_log_mel(fake, acfg, impl="xla")
                                  - jax_log_mel(b["audio"], acfg,
                                                impl="xla")))
        return (jlosses.lsgan_generator_loss(fk)
                + 2.0 * jlosses.feature_matching_loss(rf, ff) + 45.0 * mel_l1)

    jb = _j(batch)
    dval, dgrad = jax.jit(jax.value_and_grad(jdisc_loss))(dp, gp, jb)
    gval, ggrad = jax.jit(jax.value_and_grad(jgen_loss))(gp, dp, jb)
    gen = _port(HiFiGANGenerator(GAN_CFG.hifigan), gp)
    disc = _port(HiFiGANDiscriminators(width=0.125), dp)
    tb = _t(batch)
    loss, _ = disc_loss(disc, gen, tb)
    loss.backward()
    assert _rel(loss, dval) <= 1e-6
    assert_grads_match(disc, dgrad)
    assert all(p.grad is None for p in gen.parameters())
    disc.zero_grad(set_to_none=True)
    for p in disc.parameters():
        p.requires_grad_(False)
    loss, m = gen_loss(gen, disc, tb, GAN_CFG)
    loss.backward()
    assert _rel(loss, gval) <= 1e-6
    assert _rel(m["gen_total"], gval) <= 1e-6
    assert_grads_match(gen, ggrad)


def test_gan_steps_keep_their_sides_apart(gan_setup):
    """The discriminator step updates only the discriminator; the generator
    step only the generator, leaving no gradient in the discriminator."""
    batch, _, _, gp, dp = gan_setup
    gen = _port(HiFiGANGenerator(GAN_CFG.hifigan), gp)
    disc = _port(HiFiGANDiscriminators(width=0.125), dp)
    tx = adam_clipped(1e-3, 1.0, b1=0.8, b2=0.99)
    gs = TrainState.create(gen, tx, 0)
    ds = TrainState.create(disc, tx, 1)
    disc_step, gen_step = make_gan_steps(GAN_CFG)
    snap = lambda m: {k: v.clone() for k, v in m.state_dict().items()}  # noqa
    g0, d0 = snap(gen), snap(disc)
    ds, dm = disc_step(gs, ds, _t(batch))
    assert all(torch.equal(v, gen.state_dict()[k]) for k, v in g0.items())
    assert any(not torch.equal(v, disc.state_dict()[k])
               for k, v in d0.items())
    d1 = snap(disc)
    gs, gm = gen_step(gs, ds, _t(batch))
    assert all(torch.equal(v, disc.state_dict()[k]) for k, v in d1.items())
    assert all(p.grad is None for p in disc.parameters())
    assert all(p.grad is None for p in gen.parameters())
    assert all(p.requires_grad for p in disc.parameters())
    assert any(not torch.equal(v, gen.state_dict()[k])
               for k, v in g0.items())
    assert (gs.step, ds.step) == (1, 1)
    assert set(gm) == {"gen_adv", "gen_fm", "gen_mel_l1", "gen_total"}


def test_load_train_state_from_jax(jax_params):
    """A JAX PostNet-stage state's params, batch stats, frozen companions
    and counters fill a port state; its optimizer starts fresh."""
    frozen_j = {"encoder": jax_params["encoder"], "vae": jax_params["vae"]}
    js = _jax_state(jax_params["postnet"], 1e-3,
                    batch_stats=jax_params["postnet_stats"], frozen=frozen_j)
    state = _port_state(PostNet(CFG.postnet), 1e-3, frozen={
        "encoder": PhonemeEncoder(CFG.encoder),
        "vae": TextConditionedVAE(CFG.vae)})
    load_train_state_from_jax(state, numpy_tree(js.params),
                              numpy_tree(js.batch_stats),
                              numpy_tree(js.frozen), step=4, epoch=2)
    assert (state.step, state.epoch) == (4, 2)
    assert_params_match(state.params, js.params, js.batch_stats, atol=0.0)
    assert_params_match(state.frozen["vae"], frozen_j["vae"], atol=0.0)
    assert not state.optimizer.state
