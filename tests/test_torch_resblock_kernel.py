"""What surrounds the CUDA MRF resblock kernels, on the CPU: the generator's
dispatch rule, its plain path against the composition the kernels replaced,
and torch emulations of the kernels' two tile plans (narrow, 8 and 16
channels; wide, 32-256) against that composition. On a card (``cuda``
marker): the kernels against the plain version at the main path's shapes,
their launch count, exact streaming windows and their refusals. This file imports no
JAX, so on a host without it the card tests run with ``python -m pytest
--noconftest -m cuda tests/test_torch_resblock_kernel.py``."""

import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    ResBlock,
    iter_stream_windows,
)
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.ops import mrf_cuda as mc
from iris_tts_tpu_torch.runtime import seeded_generator
from iris_tts_tpu_torch.utils import prof

torch.set_num_threads(2)

SLOPE = 0.1
V1 = HiFiGANConfig()
V2 = HiFiGANConfig(upsample_initial_channel=128)
# Every stage at a width the kernel takes (32, 16, 8): the wide plan's
# narrowest and the narrow plan's.
NARROW = HiFiGANConfig(upsample_rates=(4, 2, 2),
                       upsample_kernel_sizes=(8, 4, 4),
                       upsample_initial_channel=64)


def max_abs(a, b) -> float:
    a = torch.as_tensor(a).detach().cpu().double()
    b = torch.as_tensor(b).detach().cpu().double()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max()) if a.numel() else 0.0


def scaled_(module, seed):
    """Weights at unit gain (normal, variance 1 / fan-in) and biases at
    0.1, so every layer moves its input and the epilogue sees both signs
    (the trained init, normal(0.01), leaves the residual path alone)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        with torch.no_grad():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                fan_in = p.shape[1] * p.shape[2]
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return module


def mrf_blocks(channels, seed=0, sizes=(3, 7, 11), dils=(1, 3, 5)):
    return [scaled_(ResBlock(channels, k, dils), seed + i)
            for i, k in enumerate(sizes)]


def signal(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def composition_forward(gen, mel):
    """The generator's forward as it was before the kernel, verbatim."""
    x = gen.conv_pre(mel.transpose(1, 2))
    for i in range(gen.num_ups):
        x = getattr(gen, f"ups_{i}")(F.leaky_relu(x, SLOPE))
        acc = None
        for j in range(gen.num_kernels):
            block = getattr(gen, f"resblocks_{i * gen.num_kernels + j}")
            out = block(x)
            acc = out if acc is None else acc + out
        x = acc / gen.num_kernels
    x = gen.conv_post(F.leaky_relu(x, SLOPE))
    return torch.tanh(x)[:, 0]


def generator(cfg, dtype=torch.float32, remat=False, seed=0):
    gen = HiFiGANGenerator(cfg, dtype=dtype, remat=remat)
    init_params(gen, seeded_generator(seed, "cpu"))
    return gen.eval()


# -- the kernel's tile plan, emulated --------------------------------------

LANES = 128  # positions a group of the kernel's threads covers at once
STEPS = {8: 4, 16: 4}  # positions a thread, per width (Shape<C>)


class TilePlan(NamedTuple):
    """The kernel's tiling of one layer (``Plan<C, K>`` in the source):
    ``steps`` positions a thread, strided by LANES; conv1 at
    ``conv1_positions`` = LANES × steps positions a tile, the tile's
    ``tile`` output samples plus conv2's reach ``(K − 1) / 2`` a side;
    ``smem_bytes`` of one conv's weights and the staged input (the tile,
    both reaches)."""

    steps: int
    conv1_positions: int
    tile: int
    smem_bytes: int


class WidePlan(NamedTuple):
    """The wide kernel's tiling of one conv (``WidePlan<C, K, D>`` in the
    source): a block of ``channels_out`` output channels by ``tile``
    positions, 8 × 8 of them a thread; the reduction over slices of
    ``slice_channels`` input channels, each staging the slice's weights and
    its input rows of ``row`` values (the tile, the conv's reach, padded to
    float4s) in one half of a double-buffered ring of ``smem_bytes``; a
    thread's window, 8 + reach values, is ``chunks`` float4s."""

    channels_out: int
    tile: int
    slice_channels: int
    row: int
    chunks: int
    smem_bytes: int


def wide_plan(channels, kernel_size, dilation) -> WidePlan:
    bm = min(channels, 128)
    bn = 16384 // bm
    bk = 16 if kernel_size == 3 else 8
    span = (kernel_size - 1) * dilation
    row = -(-(bn + span) // 4) * 4
    return WidePlan(bm, bn, bk, row, -(-(8 + span) // 4),
                    2 * 4 * (bk * kernel_size * bm + bk * row))


def tile_plan(channels, kernel_size, dilation):
    """The plan the kernel runs at ``channels``: a :class:`WidePlan` from 32
    channels on, else a :class:`TilePlan`."""
    if channels in mc.WIDE_CHANNELS:
        return wide_plan(channels, kernel_size, dilation)
    p1 = LANES * STEPS[channels]
    span = (kernel_size - 1) * dilation
    return TilePlan(STEPS[channels], p1, p1 - (kernel_size - 1),
                    4 * (channels * kernel_size * channels
                         + channels * (p1 + span)))



def tiled_conv(a, w, d, positions):
    """[B, C_in, n, R] staged rows → [B, C_out, n, positions]: the sum over
    c_in, then k, of w[:, c_in, k] · a[:, c_in, :, k·d + p], the kernel's
    order (bias added after)."""
    out = torch.zeros(a.shape[0], w.shape[0], a.shape[2], positions)
    for ci in range(w.shape[1]):
        for k in range(w.shape[2]):
            out = out + (w[:, ci, k].view(1, -1, 1, 1)
                         * a[:, ci:ci + 1, :, k * d:k * d + positions])
    return out


def emulate_wide_conv(x, conv, first, exact=False):
    """One launch of the wide kernel on x [B, C, T], tile by tile: stage the
    tile's input rows over the conv's reach (zeros outside [0, T); the leaky
    ReLU of them for conv1, ``first``), convolve, add the bias (and for
    conv1 apply the leaky ReLU). ``exact`` sums in the kernel's order
    (:func:`tiled_conv`); else ``F.conv1d`` sums each tile."""
    _, c, t = x.shape
    k, d = conv.weight.shape[-1], conv.dilation
    plan = wide_plan(c, k, d)
    span, bn = (k - 1) * d, plan.tile
    t0 = torch.arange(-(-t // bn)) * bn
    pos = t0[:, None] - span // 2 + torch.arange(bn + span)
    staged = torch.where((pos >= 0) & (pos < t), x[:, :, pos.clamp(0, t - 1)],
                         0.0)
    if first:
        staged = F.leaky_relu(staged, SLOPE)
    with torch.no_grad():
        if exact:
            y = tiled_conv(staged, conv.weight, d, bn)
        else:
            n = staged.shape[2]
            y = F.conv1d(staged.permute(0, 2, 1, 3).flatten(0, 1),
                         conv.weight, dilation=d)
            y = y.unflatten(0, (x.shape[0], n)).permute(0, 2, 1, 3)
        y = y + conv.bias.view(1, -1, 1, 1)
    y = y.flatten(2)[..., :t]
    return F.leaky_relu(y, SLOPE) if first else y


def emulate_layer(x, conv1, conv2, sum_in=None, n_blocks=0,
                  zero_outside=True, exact=False):
    """One launch of the kernel on x [B, C, T], tile by tile as the kernel
    runs it: stage lrelu(x) over the tile and both reaches (zeros outside
    [0, T)), conv1 over the tile and conv2's reach, lrelu(conv1 + bias)
    set to zero outside [0, T), conv2, bias, residual; then the MRF
    epilogue: add ``sum_in``, and with ``n_blocks`` multiply by the f32
    reciprocal and apply the leaky ReLU. ``zero_outside=False`` keeps
    conv1 of the padding there instead (not what the kernel does). From 32
    channels on, the wide plan's two launches (:func:`emulate_wide_conv`),
    summed in the kernel's order with ``exact``."""
    _, c, t = x.shape
    if c in mc.WIDE_CHANNELS:
        y = x + emulate_wide_conv(emulate_wide_conv(x, conv1, True, exact),
                                  conv2, False, exact)
        return mrf_epilogue(y, sum_in, n_blocks)
    k, d = conv1.weight.shape[-1], conv1.dilation
    plan = tile_plan(c, k, d)
    half, span, p1 = (k - 1) // 2, (k - 1) * d, plan.conv1_positions
    t0 = torch.arange(-(-t // plan.tile)) * plan.tile
    pos = t0[:, None] - half - span // 2 + torch.arange(p1 + span)
    staged = F.leaky_relu(x[:, :, pos.clamp(0, t - 1)], SLOPE)
    staged = torch.where((pos >= 0) & (pos < t), staged, 0.0)
    with torch.no_grad():
        h = (tiled_conv(staged, conv1.weight, d, p1)
             + conv1.bias.view(1, -1, 1, 1))
        th = t0[:, None] - half + torch.arange(p1)
        inside = (th >= 0) & (th < t) | (not zero_outside)
        h = torch.where(inside, F.leaky_relu(h, SLOPE), 0.0)
        y = (tiled_conv(F.pad(h, (0, k - 1)), conv2.weight, 1, p1)
             + conv2.bias.view(1, -1, 1, 1))
    y = y[..., :plan.tile].flatten(2)[..., :t]
    return mrf_epilogue(x + y, sum_in, n_blocks)


def mrf_epilogue(y, sum_in, n_blocks):
    """A layer's MRF step: add ``sum_in``, and with ``n_blocks`` multiply by
    the f32 reciprocal and apply the leaky ReLU."""
    if sum_in is not None:
        y = sum_in + y
    if n_blocks:
        y = F.leaky_relu(y * float(np.float32(1) / np.float32(n_blocks)),
                         SLOPE)
    return y


def emulate_mrf(x, blocks, exact=False):
    """The stage as :func:`mc.mrf_cuda` launches it: every layer of every
    block, the last layer of block j writing (j = 0), adding to (middle)
    or finishing (last) the running sum."""
    acc = None
    for j, block in enumerate(blocks):
        h = x
        pairs = block.layers()
        for step, (conv1, conv2) in enumerate(pairs):
            last = step == len(pairs) - 1
            h = emulate_layer(
                h, conv1, conv2, sum_in=acc if last and j > 0 else None,
                n_blocks=len(blocks) if last and j == len(blocks) - 1 else 0,
                exact=exact)
        acc = h
    return acc


def ragged_length(channels, k, d):
    return 2 * tile_plan(channels, k, d).tile + 37


def plan_dilations(channels, k):
    """The dilations the kernel takes at ``channels`` and kernel size k."""
    if channels in mc.WIDE_CHANNELS:
        return mc.WIDE_DILATIONS
    return range(1, mc.MAX_SPAN // (k - 1) + 1)


@pytest.mark.parametrize("channels", mc.KERNEL_CHANNELS)
@pytest.mark.parametrize("k", mc.KERNEL_SIZES)
@pytest.mark.parametrize("d", [1, 3, 5])
def test_tile_emulation_of_one_layer_matches_the_composition(channels, k, d):
    block = scaled_(ResBlock(channels, k, (d,)), channels + k + d)
    (conv1, conv2), = block.layers()
    t = ragged_length(channels, k, d)
    x = signal((2, channels, t), k * d)
    plan = tile_plan(channels, k, d)
    if channels in mc.WIDE_CHANNELS:
        # 256 threads of 8 x 8; a thread's window lies inside its row
        assert plan.channels_out * plan.tile == 256 * 64
        assert plan.row >= plan.tile - 8 + 4 * plan.chunks
        assert channels % plan.channels_out == 0
        assert channels % plan.slice_channels == 0
    else:
        assert plan.tile == plan.conv1_positions - (k - 1) > 0
    # Two blocks fit an SM's 228 KB of shared memory (1 KB reserved a block).
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    with torch.no_grad():
        want = block(x)
    got = emulate_layer(x, conv1, conv2)
    assert max_abs(got, want) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("channels", mc.KERNEL_CHANNELS)
@pytest.mark.parametrize("extra", [1, 211])
def test_tile_emulation_of_the_mrf_matches_the_composition(channels, extra):
    blocks = mrf_blocks(channels, seed=channels)
    t = tile_plan(channels, 11, 5).tile + extra
    x = signal((2, channels, t), extra)
    with torch.no_grad():
        want = mc.mrf_plain(x, blocks)
        got = emulate_mrf(x, blocks)
    assert max_abs(got, want) <= 1e-5 * float(want.abs().max())
    assert bool((want < 0).any()) and bool((want > 0).any())


def test_wide_emulation_windows_equal_the_whole_signal():
    """The wide plan summed in the kernel's order: a window of the signal
    gives the whole signal's samples bit for bit wherever it sees the same
    inputs, whatever its tiles' starts; both agree with the composition.
    Ragged: the length is no multiple of the 256-position tile."""
    blocks = mrf_blocks(64, seed=5, sizes=(3, 7))
    radius = sum(3 * d + 3 for d in (1, 3, 5))  # the K = 7 block's
    t, start, width = 700, 171, 400
    x = signal((1, 64, t), 6)
    with torch.no_grad():
        whole = emulate_mrf(x, blocks, exact=True)
        want = mc.mrf_plain(x, blocks)
        win = emulate_mrf(x[..., start:start + width], blocks, exact=True)
        edge = emulate_mrf(x[..., :width], blocks, exact=True)
    assert max_abs(whole, want) <= 1e-5 * float(want.abs().max())
    assert torch.equal(win[..., radius:-radius],
                       whole[..., start + radius:start + width - radius])
    assert torch.equal(edge[..., :-radius], whole[..., :width - radius])


def test_emulation_sees_a_conv1_edge_computed_from_padding():
    """conv1's outputs outside [0, T) are zeros, not conv1 of the zero
    padding: with a nonzero bias the two differ near both ends, and only
    the zeros give the composition back."""
    block = scaled_(ResBlock(8, 11, (5,)), 3)
    (conv1, conv2), = block.layers()
    x = signal((1, 8, 300), 4)
    with torch.no_grad():
        want = block(x)
    tol = 1e-5 * float(want.abs().max())
    assert max_abs(emulate_layer(x, conv1, conv2), want) <= tol
    padded = emulate_layer(x, conv1, conv2, zero_outside=False)
    assert max_abs(padded[..., :5], want[..., :5]) > 100 * tol
    assert max_abs(padded[..., -5:], want[..., -5:]) > 100 * tol
    assert max_abs(padded[..., 5:-5], want[..., 5:-5]) <= tol


# -- the plain path -----------------------------------------------------------


@pytest.mark.parametrize("cfg", [V2, NARROW], ids=["v2", "narrow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_equals_the_composition_bitwise(cfg, dtype):
    gen = generator(cfg, dtype)
    mel = signal((2, 6, cfg.in_channels), 1).to(dtype)
    with torch.no_grad():
        assert torch.equal(gen(mel), composition_forward(gen, mel))


def test_remat_step_runs_the_composition_bitwise():
    gen = generator(NARROW, remat=True)
    mel = signal((1, 5, NARROW.in_channels), 2)
    got = gen(mel)
    assert got.requires_grad
    assert torch.equal(got.detach(), composition_forward(gen, mel).detach())
    got.sum().backward()
    assert all(p.grad is not None for p in gen.parameters())


# -- the dispatch rule --------------------------------------------------------


def test_rule_keeps_cpu_tensors_on_the_library():
    blocks = mrf_blocks(32)
    with torch.no_grad():
        assert not mc.fused_mrf_applies(torch.zeros(1, 32, 8), blocks)


RULE_CASES = {
    "takes": (32, {}, True),
    "16_channels": (16, {}, True),
    "8_channels": (8, {}, True),
    "bfloat16_input": (32, {"dtype": torch.bfloat16}, False),
    "gradients_on": (32, {"grad": True}, False),
    "export_tracing": (32, {"compiling": True}, False),
    "64_channels": (64, {}, True),
    "128_channels": (128, {}, True),
    "256_channels": (256, {}, True),
    "512_channels": (512, {}, ValueError),
    "24_channels": (24, {}, ValueError),
    "wide_dilation_2": (64, {"dils": (1, 2, 5)}, ValueError),
    "bf16_convs": (32, {"conv_dtype": torch.bfloat16}, False),
    "kernel_size_5": (32, {"sizes": (3, 5, 7)}, ValueError),
    "dilation_too_wide": (32, {"dils": (1, 3, 9)}, ValueError),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_on_a_card_tensor(case, monkeypatch):
    channels, opts, want = RULE_CASES[case]
    monkeypatch.setattr(mc, "_on_card", lambda x: True)
    if opts.get("compiling"):
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    blocks = mrf_blocks(channels, sizes=opts.get("sizes", (3, 7, 11)),
                        dils=opts.get("dils", (1, 3, 5)))
    if "conv_dtype" in opts:
        for b in blocks:
            for pair in b.layers():
                for conv in pair:
                    conv.dtype = opts["conv_dtype"]
    x = torch.zeros(1, channels, 8, dtype=opts.get("dtype", torch.float32))
    with torch.set_grad_enabled(opts.get("grad", False)):
        if want is ValueError:
            # f32 inference on the card never leaves the kernel quietly
            with pytest.raises(ValueError, match="on the MRF kernel: "):
                mc.fused_mrf_applies(x, blocks)
        else:
            assert mc.fused_mrf_applies(x, blocks) is want


def test_threshold_takes_every_kernel_width():
    """The widths with a tile plan are the threshold: 8 and 16 channels on
    the narrow plan, 32 to 256 on the wide one, the emulation's plans (every
    stage of V1 and V2); a block reads its refusal once, when it is
    built."""
    assert set(mc.NARROW_CHANNELS) == set(STEPS)
    assert mc.KERNEL_CHANNELS == mc.NARROW_CHANNELS + mc.WIDE_CHANNELS
    for cfg in (V1, V2):
        c0 = cfg.upsample_initial_channel
        assert {c0 // 2 ** (i + 1) for i in range(len(cfg.upsample_rates))
                } <= set(mc.KERNEL_CHANNELS)
    for c in mc.KERNEL_CHANNELS:
        assert ResBlock(c, 11, (1, 3, 5)).kernel_refusal is None
    assert ResBlock(512, 3, (1, 3, 5)).kernel_refusal == (
        "no tile plan for 512 channels")
    assert ResBlock(32, 5, (1,)).kernel_refusal == "kernel size 5"
    assert ResBlock(16, 3, (2,)).kernel_refusal is None
    assert ResBlock(128, 3, (2,)).kernel_refusal == (
        "dilations (2,) at 128 channels")
    assert ResBlock(32, 3, (2,)).kernel_refusal == (
        "dilations (2,) at 32 channels")


def test_export_traces_the_library_path(monkeypatch):
    """Under ``torch.export`` the rule sees the tracer and keeps the
    library's convs, so the exported program holds no kernel call."""
    monkeypatch.setattr(mc, "_on_card", lambda x: True)
    seen = []
    rule = mc.fused_mrf_applies

    def spy(x, blocks):
        seen.append(torch.compiler.is_compiling())
        return rule(x, blocks)

    monkeypatch.setattr("iris_tts_tpu_torch.models.hifigan.fused_mrf_applies",
                        spy)
    gen = generator(NARROW)
    mel = signal((1, 6, NARROW.in_channels), 3)
    with torch.no_grad():
        ep = torch.export.export(gen, (mel,), strict=False)
        assert torch.equal(ep.module()(mel), composition_forward(gen, mel))
    assert seen and all(seen)


def test_counters_read_the_library_layers_on_the_cpu():
    gen = generator(V2)
    mel = signal((1, 4, V2.in_channels), 4)
    before = prof.counters()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gen(mel)
    after = prof.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("vocoder.fused_layers", "vocoder.library_layers")}
    assert delta == {"vocoder.fused_layers": 0, "vocoder.library_layers": 36}
    with torch.no_grad():
        gen(mel)  # no profiler: nothing counted
    assert prof.counters() == after


@pytest.mark.parametrize("cfg", [V1, V2], ids=["v1", "v2"])
def test_counters_read_every_layer_fused_where_the_kernel_runs(cfg,
                                                               monkeypatch):
    """On a card (meta tensors taken for one) every stage of V1 and V2 runs
    the kernel: 36 fused resblock layers a call, none on the library."""
    monkeypatch.setattr(mc, "_on_card", lambda x: True)
    gen = generator(cfg).to("meta")
    before = prof.counters()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gen(torch.zeros(1, 4, cfg.in_channels, device="meta"))
    after = prof.counters()
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("vocoder.fused_layers", "vocoder.library_layers")} == {
        "vocoder.fused_layers": 36, "vocoder.library_layers": 0}


# -- the counters -------------------------------------------------------------


def _on_meta(module):
    return module.to("meta")


@pytest.mark.parametrize("channels", mc.KERNEL_CHANNELS)
def test_operator_counts_as_the_composition(channels):
    """FlopCounterMode and the roofline's ByteCounter count the operator,
    run on meta tensors, as what they count of the composition it
    replaces on the CPU."""
    from iris_tts_tpu_torch.scripts import roofline

    blocks = mrf_blocks(channels)
    x = signal((2, channels, 45), 1)
    want = roofline.count_cost(mc.mrf_plain, x, blocks)
    got = roofline.count_cost(mc.mrf_stage, x.to("meta"),
                              [_on_meta(b) for b in blocks])
    assert got == want
    # rows x FLOPs a multiply-add x convs a layer x layers a block x T
    assert want[0] == 2 * 2 * 2 * 3 * 45 * channels * channels * sum(
        (3, 7, 11))


@pytest.mark.parametrize("cfg", [V2, HiFiGANConfig()], ids=["v2", "v1"])
def test_vocoder_count_through_the_operator_equals_the_cpus(cfg,
                                                            monkeypatch):
    """The generator's (FLOPs, bytes) with its stages through the
    operator (on meta tensors, taken for a card's) equal the CPU's
    composition: the roofline, ``bench.sol_of`` and ``profile_vocoder``
    read the same work on either path."""
    from iris_tts_tpu_torch.scripts import roofline

    gen = generator(cfg)
    mel = torch.zeros(1, 8, cfg.in_channels)
    want = roofline.count_cost(gen, mel)
    monkeypatch.setattr(mc, "_on_card", lambda x: True)
    launched = []
    stage = mc.mrf_stage
    monkeypatch.setattr("iris_tts_tpu_torch.models.hifigan.mrf_stage",
                        lambda x, blocks: launched.append(1) or stage(
                            x, blocks))
    got = roofline.count_cost(_on_meta(gen), mel.to("meta"))
    assert launched and got == want


def test_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="no MRF kernel for device"):
        mc.mrf_cuda(torch.zeros(1, 32, 8), mrf_blocks(32))


# -- on a card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from iris_tts_tpu_torch.runtime import pin_math_precision

    pin_math_precision()
    return torch.device("cuda")


# The stages at the main path's shapes, 32 rows × 742 frames: V2's last
# three, upsampled 8 · 8, · 2, · 2, and V1's first three, 8, · 8, · 2.
MAIN_PATH = {32: 742 * 64, 16: 742 * 128, 8: 742 * 256,
             256: 742 * 8, 128: 742 * 64, 64: 742 * 128}
# Kernel vs plain, of the plain output's peak. Both sum each output in f32,
# the kernel in one fixed order (c_in, then k) that on the H100 has matched
# cuDNN's bit for bit; another order would move a sum of up to 2816
# products a conv over 9 layers by ~1e-6 of the peak, so 1e-5 leaves room
# without hiding a wrong tap or channel (those move it by ~1e-1).
PLAIN_LIMIT = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("channels", sorted(MAIN_PATH))
def test_kernel_matches_the_plain_version_on_card(channels, card):
    blocks = [b.to(card) for b in mrf_blocks(channels, seed=channels)]
    x = signal((32, channels, MAIN_PATH[channels]), channels).to(card)
    with torch.inference_mode():
        got = mc.mrf_cuda(x, blocks)
        want = mc.mrf_plain(x, blocks)
    torch.cuda.synchronize()
    assert max_abs(got, want) <= PLAIN_LIMIT * float(want.abs().max())


@pytest.mark.cuda
def test_kernel_plan_matches_the_emulation_on_card(card):
    """Every width, kernel size and dilation the kernel takes, one layer
    at a length of two tiles of the emulated plan and a ragged rest,
    against the emulation (one block: the layer's epilogue finishes the
    average of one)."""
    for c in mc.KERNEL_CHANNELS:
        for k in mc.KERNEL_SIZES:
            for d in plan_dilations(c, k):
                block = scaled_(ResBlock(c, k, (d,)), c + k + d)
                x = signal((2, c, ragged_length(c, k, d)), d)
                with torch.no_grad():
                    want = emulate_mrf(x, [block])
                with torch.inference_mode():
                    got = mc.mrf_cuda(x.to(card), [block.to(card)])
                assert max_abs(got, want) <= 1e-5 * float(want.abs().max()), (
                    c, k, d)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", mc.WIDE_CHANNELS)
def test_wide_plan_takes_an_input_at_any_offset_on_card(channels, card):
    """The wide epilogue reads the residual, the caller's input, as float4s
    only where its rows are 16-byte aligned: a contiguous view one float
    into its storage, at a length that is a multiple of 4, still matches
    the plain version."""
    blocks = [b.to(card) for b in mrf_blocks(channels, seed=11)]
    flat = signal((1 + 2 * channels * 304,), 12).to(card)
    x = flat[1:].view(2, channels, 304)
    assert x.is_contiguous() and x.data_ptr() % 16
    with torch.inference_mode():
        got = mc.mrf_cuda(x, blocks)
        want = mc.mrf_plain(x, blocks)
    assert max_abs(got, want) <= PLAIN_LIMIT * float(want.abs().max())


@pytest.mark.cuda
def test_vocoder_count_on_card_equals_the_cpus(card):
    from iris_tts_tpu_torch.scripts import roofline

    gen = generator(V2)
    mel = torch.zeros(1, 32, V2.in_channels)
    want = roofline.count_cost(gen, mel)
    before = mc.mrf_cuda.launches
    got = roofline.count_cost(gen.to(card), mel.to(card))
    # 9 layers a stage: one launch each at 16/8 channels, two at 64/32
    assert mc.mrf_cuda.launches - before == 18 + 36
    assert got == want


@pytest.mark.cuda
def test_generator_counts_launches_and_layers_on_card(card):
    gen = generator(V2).to(card)
    mel = signal((2, 40, V2.in_channels), 5).to(card)
    before, counted = mc.mrf_cuda.launches, prof.counters()
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = gen(mel)
    after = prof.counters()
    assert mc.mrf_cuda.launches - before == 18 + 36
    assert {k: after.get(k, 0) - counted.get(k, 0)
            for k in ("vocoder.fused_layers", "vocoder.library_layers")} == {
        "vocoder.fused_layers": 36, "vocoder.library_layers": 0}
    with torch.no_grad():
        want = composition_forward(gen, mel)
    assert max_abs(got, want) <= PLAIN_LIMIT * float(want.abs().max())
    with torch.enable_grad():
        gen(mel)  # the GAN step's path: no launch
    assert mc.mrf_cuda.launches - before == 18 + 36


@pytest.mark.cuda
@pytest.mark.parametrize("channels", sorted(MAIN_PATH))
def test_kernel_windows_equal_the_whole_signal_on_card(channels, card):
    """A window of the signal gives the whole signal's samples exactly
    wherever it sees the same inputs: the kernel sums each sample in one
    order, wherever its tile starts."""
    blocks = [b.to(card) for b in mrf_blocks(channels, seed=7)]
    radius = max(sum((k - 1) // 2 * d + (k - 1) // 2 for d in (1, 3, 5))
                 for k in (3, 7, 11))
    t, chunk = 5000, 701
    x = signal((1, channels, t), 8).to(card)
    with torch.inference_mode():
        whole = mc.mrf_cuda(x, blocks)
        for a, b, w0, start, _ in iter_stream_windows(t, chunk, radius):
            win = mc.mrf_cuda(x[..., w0:w0 + chunk + 2 * radius].contiguous(),
                              blocks)
            assert torch.equal(win[..., start:start + b - a],
                               whole[..., a:b])


@pytest.mark.cuda
def test_vocode_streaming_equals_vocode_on_card(card):
    from iris_tts_tpu_torch.config import IrisConfig
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline

    cfg = dataclasses.replace(IrisConfig(), hifigan=V2)
    pipe = TTSPipeline.initialize(cfg, seed=3, device=card)
    mel = np.random.default_rng(7).normal(
        -3.0, 2.0, (700, V2.in_channels)).astype(np.float32)
    before = mc.mrf_cuda.launches
    full = pipe.vocode(mel)
    got = np.concatenate(list(pipe.vocode_streaming(mel, chunk_frames=64)))
    assert mc.mrf_cuda.launches > before
    assert got.shape == full.shape
    assert np.array_equal(got, full)


@pytest.mark.cuda
def test_inference_on_a_shape_without_a_plan_raises_on_card(card):
    """f32 inference on the card does not leave the kernel quietly: a stage
    of a width or dilation the kernel has no plan for raises, where the
    GAN step's path (gradients on) runs the library's convs."""
    gen = generator(dataclasses.replace(
        V2, resblock_dilations=((1, 2, 5), (1, 3, 5), (1, 3, 5)))).to(card)
    mel = signal((1, 20, V2.in_channels), 6).to(card)
    with torch.inference_mode():
        with pytest.raises(ValueError, match=r"dilations \(1, 2, 5\) at 64"):
            gen(mel)
    with torch.enable_grad():
        assert gen(mel).shape == (1, 20 * V2.total_upsample)
    blocks = [b.to(card) for b in mrf_blocks(24)]
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="tile plan for 24"):
        mc.fused_mrf_applies(signal((1, 24, 50), 1).to(card), blocks)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take_on_card(card):
    blocks = [b.to(card) for b in mrf_blocks(16)]
    x = signal((2, 16, 300), 9).to(card)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            mc.mrf_cuda(x.transpose(0, 1).contiguous().transpose(0, 1),
                        blocks)
        with pytest.raises(TypeError, match="float32"):
            mc.mrf_cuda(x.to(torch.bfloat16), blocks)
        with pytest.raises(ValueError, match="tile plan for 24"):
            mc.mrf_cuda(signal((1, 24, 50), 1).to(card), mrf_blocks(24))
