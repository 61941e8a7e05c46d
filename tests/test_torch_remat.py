"""Remat (``torch.utils.checkpoint``) in the PyTorch port, on the CPU at
small widths: the counterparts of the JAX package's
``tests/test_train_steps.py::test_remat_vae_step_matches_no_remat`` and
``tests/test_gan.py::test_gan_remat_generator_matches_no_remat``, with
dropout active in the VAE, plus bf16 with remat.

JAX holds the forward losses bit-identical and the params to rtol 1e-6;
here the recompute runs the same kernels on the same inputs, so the same
bounds hold (in practice the params are bitwise equal too).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from iris_tts_tpu_torch.config import AudioConfig, HiFiGANConfig
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.encoder import PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import (
    checkpoint_block,
    init_params,
    module_dtype,
)
from iris_tts_tpu_torch.models.vae import TextConditionedVAE, WaveNetResBlock
from iris_tts_tpu_torch.train.gan import make_gan_steps
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from iris_tts_tpu_torch.train.steps import make_vae_train_step
from tests.test_torch_train import CFG, _batch, _t

torch.set_num_threads(2)

# The VAE with dropout on (the tiny config turns it off everywhere).
VAE_CFG = dataclasses.replace(CFG, vae=dataclasses.replace(CFG.vae,
                                                           dropout=0.3))


def _grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters()
            if p.grad is not None}


def test_checkpoint_block_replays_the_generators_dropout_masks():
    """A WaveNet block with dropout, its masks drawn from an explicit
    generator: under ``checkpoint_block`` the gradients equal the stored
    activations' bitwise and the generator advances once, as without
    remat. Plain ``torch.utils.checkpoint`` redraws other masks in the
    recompute from the generator that has moved on, and its gradients are
    wrong: the fault ``checkpoint_block`` exists for."""
    block = WaveNetResBlock(8, 6, 3, dilation=2, dropout=0.5)
    init_params(block, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 20, generator=torch.Generator().manual_seed(1))
    cond = torch.randn(2, 6, 20, generator=torch.Generator().manual_seed(2))

    def run(how):
        block.zero_grad(set_to_none=True)
        g = torch.Generator().manual_seed(7)
        xi = x.clone().requires_grad_(True)
        if how == "stored":
            y = block(xi, cond, False, g)
        elif how == "replayed":
            y = checkpoint_block(block, xi, cond, False, generator=g)
        else:
            y = checkpoint(block, xi, cond, False, g, use_reentrant=False)
        (y.square().sum() + y.sum()).backward()
        return y.detach(), _grads(block), xi.grad, g.get_state()

    y0, g0, x0, s0 = run("stored")
    y1, g1, x1, s1 = run("replayed")
    y2, g2, x2, _ = run("plain checkpoint")
    assert torch.equal(y0, y1) and torch.equal(y0, y2)  # same forward
    assert set(g0) == set(g1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(x0, x1)
    assert torch.equal(s0, s1)  # the live generator advanced once
    assert not all(torch.equal(g0[k], g2[k]) for k in g0)


def _vae_state(remat_seed=0):
    encoder = PhonemeEncoder(VAE_CFG.encoder)
    init_params(encoder, torch.Generator().manual_seed(1))
    vae = TextConditionedVAE(VAE_CFG.vae)
    init_params(vae, torch.Generator().manual_seed(2))
    # Move the zero-initialised heads off zero so every path trains.
    with torch.no_grad():
        g = torch.Generator().manual_seed(3)
        for p in vae.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return TrainState.create(vae, adam_clipped(1e-3, 1.0), remat_seed,
                             frozen={"encoder": encoder})


def test_remat_vae_step_matches_no_remat():
    """``make_vae_train_step(remat=True)`` with dropout active: three steps'
    losses are bit-identical to the stored-activation step's, the params
    agree to rtol 1e-6, and the generators end in the same state."""
    outs = {}
    for remat in (False, True):
        state = _vae_state()
        step = make_vae_train_step(VAE_CFG, remat=remat)
        losses = []
        for i in range(3):
            state, m = step(state, _t(_batch(i)), torch.tensor(0.01))
            losses.append(float(m["total"]))
        assert state.params.remat is False  # a step leaves the module as is
        outs[remat] = (losses, state.params.state_dict(),
                       state.generator.get_state())
    assert outs[False][0] == outs[True][0]
    for k, v in outs[False][1].items():
        torch.testing.assert_close(outs[True][1][k], v, rtol=1e-6, atol=1e-8)
    assert torch.equal(outs[False][2], outs[True][2])


def test_remat_vae_step_in_bf16():
    """bf16 and remat together: finite losses that fall on a fixed batch,
    f32 params, and the same losses as bf16 without remat."""
    outs = {}
    for remat in (False, True):
        state = _vae_state()
        step = make_vae_train_step(VAE_CFG, compute_dtype=torch.bfloat16,
                                   remat=remat)
        batch = _t(_batch(0))
        losses = [float(step(state, batch, torch.tensor(0.01))[1]["total"])
                  for _ in range(6)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert all(p.dtype == torch.float32
                   for p in state.params.parameters())
        assert module_dtype(state.params) == torch.float32
        outs[remat] = losses
    assert outs[False] == outs[True]


# A generator whose hop (4 × 2) matches the audio config's, so real and
# generated audio lengths agree in the GAN losses.
GAN_CFG = dataclasses.replace(
    CFG,
    hifigan=HiFiGANConfig(in_channels=CFG.vae.n_mels, upsample_rates=(4, 2),
                          upsample_kernel_sizes=(8, 4),
                          upsample_initial_channel=16,
                          resblock_kernel_sizes=(3, 5),
                          resblock_dilations=((1, 3), (1,))),
    audio=AudioConfig(n_fft=64, hop_length=8, win_length=64, n_mels=8))


def _gan_states():
    gen = HiFiGANGenerator(GAN_CFG.hifigan)
    init_params(gen, torch.Generator().manual_seed(4))
    with torch.no_grad():  # audible fake audio: scale the normal(0.01) init
        for n, p in gen.named_parameters():
            if n.endswith("weight"):
                p.mul_(8.0)
    disc = HiFiGANDiscriminators(periods=(2,), num_scales=1, width=0.25)
    init_params(disc, torch.Generator().manual_seed(5))
    tx = adam_clipped(1e-3, 1.0, b1=0.8, b2=0.99)
    return TrainState.create(gen, tx, 0), TrainState.create(disc, tx, 1)


def _gan_batch():
    rng = np.random.default_rng(0)
    t = 16
    return {"mel": torch.from_numpy(rng.standard_normal(
                (2, t, GAN_CFG.hifigan.in_channels)).astype(np.float32)),
            "audio": torch.from_numpy((0.1 * rng.standard_normal(
                (2, t * 8))).astype(np.float32))}


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_gan_remat_generator_matches_no_remat(compute_dtype):
    """``make_gan_steps(remat=True)``: the MRF resblocks rematerialise in
    the generator's backward pass; a discriminator step then a generator
    step give the same losses (bit-identical) and generator params (rtol
    1e-6) as without remat, in f32 and in bf16, with f32 params and finite
    losses."""
    outs = {}
    for remat in (False, True):
        gs, ds = _gan_states()
        d_step, g_step = make_gan_steps(GAN_CFG, compute_dtype=compute_dtype,
                                        remat=remat)
        ds, dm = d_step(gs, ds, _gan_batch())
        gs, gm = g_step(gs, ds, _gan_batch())
        assert np.isfinite(float(dm["disc_loss"]))
        assert np.isfinite(float(gm["gen_total"]))
        assert all(p.dtype == torch.float32 for p in gs.params.parameters())
        assert gs.params.remat is False
        outs[remat] = (float(dm["disc_loss"]), float(gm["gen_total"]),
                       gs.params.state_dict())
    assert outs[False][:2] == outs[True][:2]
    for k, v in outs[False][2].items():
        torch.testing.assert_close(outs[True][2][k], v, rtol=1e-6, atol=1e-8)


def test_remat_leaves_inference_alone():
    """With gradients off, remat changes nothing: the generator's output is
    bitwise the same and no checkpoint runs."""
    gen = HiFiGANGenerator(GAN_CFG.hifigan, remat=True)
    init_params(gen, torch.Generator().manual_seed(4))
    mel = _gan_batch()["mel"]
    with torch.no_grad():
        a = gen(mel)
        gen.remat = False
        b = gen(mel)
    assert torch.equal(a, b)
