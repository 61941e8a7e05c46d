"""Port parity: G2P training (``models/g2p.py``, ``scripts/train_g2p.py``,
``text.neural_g2p.save_g2p``) against the JAX package's.

A tiny JAX-initialised G2P (embed 32, 4 heads, 2 + 2 blocks) is carried
across with ``module_state_from_jax``; the same numpy inputs go through
both. Tolerances: encoder output and logits ≤ 1e-5; greedy tokens exact;
loss ≤ 1e-6 relative and every gradient leaf ≤ 1e-5 of the largest |g|
(dropout off); the schedule within 1e-6 of optax's at every step, relative
or of the peak lr (optax computes in float32: near the cosine's end, 1 +
cos cancels, and its float32 value is 1e-6 off the float64 one there);
three AdamW steps ≤ 2e-5 in params, except the attention key biases. Their
gradient is zero in exact arithmetic (a softmax ignores a shift shared by
every key), so Adam turns either package's rounding-level gradient into a
step of up to lr: they are held to 3 × lr.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import iris_tts_tpu.models.g2p as jg2p
from iris_tts_tpu.text.neural_g2p import load_g2p as jax_load_g2p
from iris_tts_tpu.text.neural_g2p import save_g2p as jax_save_g2p
from iris_tts_tpu_torch.convert.from_jax import module_state_from_jax
from iris_tts_tpu_torch.convert.to_jax import jax_params_from_module
from iris_tts_tpu_torch.models.g2p import G2PTransformer, greedy_decode
from iris_tts_tpu_torch.scripts import train_g2p
from iris_tts_tpu_torch.text.lexicon import ARPABET
from iris_tts_tpu_torch.text.neural_g2p import (
    DEFAULT_CHECKPOINT,
    G2PConfig,
    NeuralG2P,
    _NumpyG2P,
    _read_checkpoint,
    save_g2p,
)
from iris_tts_tpu_torch.train.schedules import warmup_cosine_decay_schedule

TINY = dict(embed_dim=32, num_heads=4, enc_blocks=2, dec_blocks=2)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_greedy(jmod, variables, chars):
    return jax.jit(lambda v, c: jg2p.greedy_decode(jmod, v, c))(
        variables, jnp.asarray(chars))


def _port_model(jax_params, cfg: G2PConfig) -> G2PTransformer:
    model = G2PTransformer(cfg)
    model.load_state_dict(module_state_from_jax(
        _np_tree(jax_params), module=model), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    """(JAX module, JAX variables, port model, port config)."""
    jcfg = jg2p.G2PConfig(**TINY)
    jmod = jg2p.G2PTransformer(jcfg)
    key = jax.random.PRNGKey(3)
    variables = jax.jit(jmod.init)(
        {"params": key, "dropout": key},
        jnp.zeros((2, jcfg.max_word_len), jnp.int32),
        jnp.zeros((2, jcfg.max_phone_len), jnp.int32))
    cfg = G2PConfig(**TINY)
    return jmod, variables, _port_model(variables["params"], cfg), cfg


@pytest.fixture(scope="module")
def data():
    """The port's dataset at --max_entries 2000 (default widths)."""
    return train_g2p.build_dataset(G2PConfig(), 2000)


@pytest.fixture(scope="module")
def held_out():
    """64 words of the whole dictionary's validation split."""
    chars, _, _, is_val = train_g2p.build_dataset(G2PConfig())
    return chars[is_val][:64]


def test_build_dataset_equals_jax(data):
    from scripts.train_g2p import build_dataset as jax_build_dataset

    want = jax_build_dataset(jg2p.G2PConfig(), 2000)
    assert len(want[0]) > 1500 and want[3].any()
    for got, ref in zip(data, want):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_phone_error_rate_matches_jax():
    from scripts.train_g2p import phone_error_rate as jax_per

    rng = np.random.default_rng(0)
    for _ in range(50):
        a = rng.integers(3, 8, rng.integers(0, 9)).tolist()
        b = rng.integers(3, 8, rng.integers(0, 9)).tolist()
        assert train_g2p.phone_error_rate(a, b) == jax_per(a, b)


def test_encoder_and_logits_match_jax(tiny, data):
    jmod, variables, model, _ = tiny
    chars, pin = data[0][:16], data[1][:16]
    enc_j, valid_j = jax.jit(lambda v, c: jmod.apply(
        v, c, method=jmod.encode))(variables, jnp.asarray(chars))
    want = jax.jit(jmod.apply)(variables, jnp.asarray(chars),
                               jnp.asarray(pin))
    with torch.no_grad():
        enc, valid = model.encode(torch.from_numpy(chars).long())
        got = model(torch.from_numpy(chars).long(),
                    torch.from_numpy(pin).long())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert float(np.abs(enc.numpy() - np.asarray(enc_j)).max()) <= 1e-5
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5


def test_pad_characters_are_inert(tiny, data):
    """The encoding is zero at PAD characters, and trailing PAD columns
    change no logit."""
    _, _, model, _ = tiny
    chars = torch.from_numpy(data[0][:8]).long()
    pin = torch.from_numpy(data[1][:8]).long()
    width = int((chars != 0).sum(1).max())
    with torch.no_grad():
        enc, valid = model.encode(chars)
        full = model(chars, pin)
        cut = model(chars[:, :width], pin)
    assert float(enc[~valid].abs().max()) == 0.0
    # Another width is another matmul shape: rounding apart, held to the
    # logits' 1e-5.
    assert float((full - cut).abs().max()) <= 1e-5


def test_greedy_decode_equals_jax(tiny, held_out):
    jmod, variables, model, _ = tiny
    chars = held_out
    assert len(chars) == 64
    want = np.asarray(_jax_greedy(jmod, variables, chars))
    got = greedy_decode(model, torch.from_numpy(chars).long())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_loss(jmod, params, c, yi, yo):
    logits = jmod.apply(params, c, yi, deterministic=True)
    mask = (yo != 0).astype(jnp.float32)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, yo)
    return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def _grad_tree(model):
    """The port's gradients laid out as the flax params tree."""
    clone = G2PTransformer(model.config)
    clone.load_state_dict({n: p.grad for n, p in model.named_parameters()},
                          strict=False)
    return jax_params_from_module(clone)


@pytest.fixture(scope="module")
def jax_value_and_grad(tiny):
    """JAX's loss and gradients with dropout off, compiled once."""
    jmod = tiny[0]
    return jax.jit(jax.value_and_grad(
        lambda v, c, yi, yo: _jax_loss(jmod, v, c, yi, yo)))


def test_loss_and_gradients_match_jax(tiny, data, jax_value_and_grad):
    _, variables, _, cfg = tiny
    c, yi, yo = (a[:64] for a in data[:3])
    want_loss, want_g = jax_value_and_grad(
        variables, jnp.asarray(c), jnp.asarray(yi), jnp.asarray(yo))
    model = _port_model(variables["params"], cfg)
    loss = train_g2p.loss_fn(model, *(torch.from_numpy(a).long()
                                      for a in (c, yi, yo)),
                             deterministic=True)
    loss.backward()
    got_loss = float(loss.detach())
    assert abs(got_loss - float(want_loss)) <= 1e-6 * float(want_loss)
    got = _grad_tree(model)
    want = _np_tree(want_g["params"])
    gmax = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want))
    worst = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert worst <= 1e-5 * gmax, (worst, gmax)


@pytest.mark.parametrize("warmup", [0, 1, 12])
def test_schedule_equals_optax(warmup):
    lr, total = 1e-3, 240
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total,
                                              end_value=lr * 1e-2)
    got = warmup_cosine_decay_schedule(0.0, lr, warmup, total,
                                       end_value=lr * 1e-2)
    for step in range(total + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * lr, err_msg=f"step {step}")


def test_three_adamw_steps_match_optax(tiny, data, jax_value_and_grad):
    _, variables, _, cfg = tiny
    lr, wd, total, warmup = 1e-3, 1e-4, 240, 1
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total,
                                               end_value=lr * 1e-2)
    tx = optax.adamw(sched, weight_decay=wd)
    params = variables
    opt = tx.init(params)

    @jax.jit
    def update(grads, opt, params):
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt

    state = train_g2p.make_state(cfg, 0, "cpu", lr, wd, warmup, total)
    state.params.load_state_dict(module_state_from_jax(
        _np_tree(variables["params"]), module=state.params), strict=True)
    for i in range(3):
        c, yi, yo = (a[64 * i:64 * (i + 1)] for a in data[:3])
        _, grads = jax_value_and_grad(params, jnp.asarray(c),
                                      jnp.asarray(yi), jnp.asarray(yo))
        params, opt = update(grads, opt, params)
        train_g2p.train_step(state, *(torch.from_numpy(a).long()
                                      for a in (c, yi, yo)),
                             deterministic=True)
    assert state.step == 3
    got = jax.tree_util.tree_flatten_with_path(
        jax_params_from_module(state.params))[0]
    want = jax.tree_util.tree_flatten_with_path(_np_tree(params["params"]))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        name = jax.tree_util.keystr(path)
        err = float(np.abs(a - b).max())
        limit = 3 * lr if "'key']['bias'" in name else 2e-5
        assert err <= limit, (name, err)


def test_save_g2p_matches_jax_format_and_loads_in_jax(tiny, tmp_path, data):
    jmod, variables, model, cfg = tiny
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    meta = {"val_per": 0.5, "epochs": 1}
    save_g2p(ours, {"params": jax_params_from_module(model)}, cfg, meta)
    jax_save_g2p(theirs, variables, jg2p.G2PConfig(**TINY), meta)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            if k == "__manifest__":
                assert json.loads(str(a[k])) == json.loads(str(b[k]))
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # JAX reads the port's checkpoint, and decodes as the port does.
    jparams, jcfg, jmeta = jax_load_g2p(ours)
    assert jmeta == meta and jcfg == jg2p.G2PConfig(**TINY)
    chars = data[0][data[3]][:32]
    want = np.asarray(_jax_greedy(jg2p.G2PTransformer(jcfg), jparams, chars))
    flat, pcfg, _ = _read_checkpoint(ours)
    reloaded = _port_model(jparams["params"], pcfg)
    got = greedy_decode(reloaded, torch.from_numpy(chars).long())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _NumpyG2P(flat, pcfg).greedy_decode(chars), want)


def test_shipped_checkpoint_decodes_as_numpy_and_jax(held_out):
    """Full width: the port's torch decoder on the shipped checkpoint
    equals the host NumPy decoder and JAX's on 64 held-out words."""
    flat, cfg, _ = _read_checkpoint(DEFAULT_CHECKPOINT)
    jparams, jcfg, _ = jax_load_g2p(DEFAULT_CHECKPOINT)
    chars = held_out
    model = _port_model(jparams["params"], cfg)
    got = greedy_decode(model, torch.from_numpy(chars).long()).numpy()
    np.testing.assert_array_equal(got, _NumpyG2P(flat, cfg).greedy_decode(
        chars))
    want = np.asarray(_jax_greedy(jg2p.G2PTransformer(jcfg), jparams, chars))
    np.testing.assert_array_equal(got, want)


def test_cli_trains_a_checkpoint_neural_g2p_reads(tmp_path):
    out = tmp_path / "g2p_tiny.npz"
    summary = train_g2p.main([
        "--max_entries", "300", "--epochs", "2", "--batch_size", "128",
        "--embed_dim", "32", "--enc_blocks", "1", "--dec_blocks", "1",
        "--eval_every", "2", "--device", "cpu", "--output", str(out)])
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    g = NeuralG2P(out)
    phones = g("wug")
    assert all(p in ARPABET for p in phones)
    _, cfg, meta = _read_checkpoint(out)
    assert cfg.embed_dim == 32 and meta["epochs"] == 2
    assert meta["train_entries"] == summary["train_entries"]
