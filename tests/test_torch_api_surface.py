"""The port's public members and signatures against the JAX package's.

``tests/test_torch_exports.py`` diffs the names each subpackage exports.
This file goes one level down: for every class and function in the JAX
subpackages' ``__all__`` (and ``CheckpointManager``, which JAX's
``train`` reaches by module path), the port has every public method JAX's
own classes define, and JAX's parameters, in JAX's order, start the port's
parameter list, so a call written for JAX (positional or keyword) binds the
same way. The port may add parameters after JAX's (``device`` everywhere,
and the extras named below).

The allowlists name the deliberate differences, each with its reason; a
difference that is not on them fails. Behaviour tests below hold the
repaired members to what they do.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import threading
import types

import numpy as np
import pytest
import torch

import iris_tts_tpu

# qualified name → JAX parameters the port does not take, and why.
MISSING_PARAMS = {
    "ops.log_mel_spectrogram": ({"use_matmul_dft"},
                                "a TPU lowering switch of the JAX op"),
    "serve.export_pipeline": ({"platforms"},
                              "a StableHLO target list; the port exports "
                              "for the pipeline's own device"),
}
# qualified name → why the whole signature differs.
OTHER_SIGNATURE = {
    "train.TrainState": "a flax struct's fields; the port's state holds a "
                        "module, its optimizer and a torch.Generator",
    "train.TrainState.create": "flax's rng key and batch_stats collection; "
                               "the port takes a seed for its generator "
                               "and keeps BatchNorm statistics in the module",
    "train.TrainState.apply_gradients": "flax's functional update takes the "
                                        "grads; the port's reads each "
                                        "parameter's .grad",
    "models.TTSPipeline": "the dataclass holds a torch module (model) where "
                          "JAX's holds a params pytree, and JAX's "
                          "packed_fetch is its TPU wire format",
}
# qualified name → parameters the port adds after JAX's (beyond ``device``).
EXTRA_PARAMS = {
    # BigVGAN-v2's key (models/bigvgan.py), which the JAX package lacks.
    "HiFiGANConfig": {"activation"},
    "models.TTSPipeline.from_checkpoints": {"seed"},
    "models.TextConditionedVAE.generate": {"generator"},
    "parallel.initialize_multihost": {"backend", "timeout_s"},
    "parallel.shard_batch": {"axis"},
    "serve.export_pipeline": {"native"},
    "train.adam_clipped": {"b1", "b2"},
    "train.CheckpointManager": {"mesh"},
}
# qualified name → JAX members the port's class does not have, and why.
MISSING_MEMBERS = {
    "train.TrainState.replace": "flax struct's functional copy; the port's "
                                "state is updated in place",
}
# qualified name → why the port leaves the JAX name out (the exports test
# allows the same names).
NOT_PORTED = {
    "utils.StepTimer": "read by nothing in the port",
    "utils.profile_stats": "read by nothing in the port",
}
# Methods every flax module has that a torch module has no use for.
FLAX_HOOKS = {"setup"}
# Classes reached by module path rather than through an ``__all__``.
BY_PATH = [("train", "iris_tts_tpu.train.checkpoint", "CheckpointManager")]


def _cases():
    subs = [""] + sorted(m.name for m in pkgutil.iter_modules(
        iris_tts_tpu.__path__) if m.ispkg)
    out = []
    for sub in subs:
        mod = importlib.import_module("iris_tts_tpu" + ("." + sub if sub
                                                        else ""))
        out += [(sub, mod.__name__, name)
                for name in sorted(getattr(mod, "__all__", ()))]
    return out + BY_PATH


def _qual(sub, name):
    return f"{sub}.{name}" if sub else name


def _params(fn):
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return None
    return [p.name for p in params
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _check_signature(qual, jax_fn, port_fn, drop_first=False):
    if qual in OTHER_SIGNATURE:
        return
    want, got = _params(jax_fn), _params(port_fn)
    if want is None or got is None:
        return
    if drop_first:  # self / cls
        want, got = want[1:], got[1:]
    missing, why = MISSING_PARAMS.get(qual, (set(), ""))
    assert missing <= set(want), (qual, missing - set(want), why)
    want = [p for p in want if p not in missing]
    assert got[:len(want)] == want, (
        f"{qual}: JAX's parameters {want} do not start the port's {got}")
    extra = set(got[len(want):]) - {"device"} - EXTRA_PARAMS.get(qual, set())
    assert not extra, f"{qual}: the port adds {sorted(extra)}"


def _is_jax_module(cls):
    mod = getattr(cls, "__module__", "") or ""
    return mod == "iris_tts_tpu" or mod.startswith("iris_tts_tpu.")


def _jax_members(cls):
    """JAX's own public methods and properties of ``cls`` (not flax's)."""
    out = {}
    for klass in reversed(cls.__mro__):
        if not _is_jax_module(klass):
            continue
        for name, value in vars(klass).items():
            if name.startswith("_"):
                continue
            if isinstance(value, (classmethod, staticmethod, property)) or (
                    inspect.isfunction(value)):
                out[name] = value
    return out


@pytest.mark.parametrize("sub,module,name", _cases(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_port_binds_like_jax(sub, module, name):
    import flax.linen as fnn

    jax_obj = getattr(importlib.import_module(module), name)
    port_mod = importlib.import_module(
        module.replace("iris_tts_tpu", "iris_tts_tpu_torch", 1))
    qual = _qual(sub, name)
    if qual in NOT_PORTED:
        assert not hasattr(port_mod, name), f"take {qual} off NOT_PORTED"
        return
    port_obj = getattr(port_mod, name)
    if not inspect.isclass(jax_obj):
        if callable(jax_obj):
            _check_signature(qual, jax_obj, port_obj)
        return
    assert inspect.isclass(port_obj), qual
    flax_module = issubclass(jax_obj, fnn.Module)
    if not flax_module:  # a flax module's constructor is flax's dataclass
        _check_signature(qual, jax_obj, port_obj)
    for member, value in _jax_members(jax_obj).items():
        mqual = f"{qual}.{member}"
        if mqual in MISSING_MEMBERS or (flax_module
                                        and member in FLAX_HOOKS):
            continue
        assert hasattr(port_obj, member), f"the port's {qual} lacks {member}"
        if isinstance(value, property):
            continue
        raw = inspect.getattr_static(port_obj, member)
        bound_jax = not isinstance(value, staticmethod)
        bound_port = not isinstance(raw, staticmethod)
        assert bound_jax == bound_port, mqual
        _check_signature(mqual, getattr(jax_obj, member),
                         getattr(port_obj, member),
                         drop_first=bound_jax and not isinstance(
                             value, classmethod))


def test_allowlists_name_real_members():
    """Every allowlisted name exists in the JAX package, so the lists
    shrink when a difference goes."""
    cases = {_qual(sub, name): (module, name)
             for sub, module, name in _cases()}
    for qual in (set(MISSING_PARAMS) | set(OTHER_SIGNATURE)
                 | set(EXTRA_PARAMS) | set(MISSING_MEMBERS)
                 | set(NOT_PORTED)):
        head, _, tail = qual.rpartition(".")
        if qual in cases:
            module, name = cases[qual]
            assert hasattr(importlib.import_module(module), name), qual
        else:
            assert head in cases, qual
            module, name = cases[head]
            cls = getattr(importlib.import_module(module), name)
            assert hasattr(cls, tail), qual


# -- behaviour of the repaired members ------------------------------------------


def _linear_state(fill=1.0):
    from iris_tts_tpu_torch.train.state import TrainState, adam_clipped

    m = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(fill)
    return TrainState.create(m, adam_clipped(1e-3), 0)


def test_checkpoint_manager_takes_jax_arguments(tmp_path):
    """``save(step, state, metrics, val_metric, wait, epoch)`` in JAX's
    positional order; the metrics land beside the checkpoint and go with
    it; ``wait_until_finished``/``close`` return (saves are synchronous);
    ``restore(state_template=...)``."""
    import json

    from iris_tts_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(tmp_path, max_to_keep=1, keep_every_n=0)
    assert ckpt.save(1, _linear_state(1.0), {"loss": torch.tensor(0.25)},
                     0.5, True, 1) is True
    assert json.loads((tmp_path / "step_0000000001.metrics.json")
                      .read_text()) == {"loss": 0.25}
    ckpt.wait_until_finished()
    later = _linear_state(2.0)
    later.step = 2
    assert ckpt.save(2, later, metrics={"loss": 0.5}, wait=True) is False
    assert ckpt.all_steps() == [2]
    assert not (tmp_path / "step_0000000001.metrics.json").exists()
    got = ckpt.restore(state_template=_linear_state(0.0))
    assert got.step == 2 and float(got.params.weight.detach()[0, 0]) == 2.0
    ckpt.close()


def test_running_mean_reset():
    from iris_tts_tpu_torch.utils.metrics import RunningMean

    rm = RunningMean()
    rm.update({"a": 1.0, "b": 3.0})
    rm.update({"a": 3.0})
    assert rm.means() == {"a": 2.0, "b": 3.0}
    rm.reset()
    assert rm.means() == {}
    rm.update({"a": 5.0})
    assert rm.means() == {"a": 5.0}


class _WarmOnlyPipeline:
    """The batcher's view of an ahead-of-time pipeline: ``warmup()`` and
    ``synthesize()``; records the thread each warmup runs on."""

    phoneme_buckets = (16,)
    config = types.SimpleNamespace(
        audio=types.SimpleNamespace(sample_rate=22050),
        hifigan=types.SimpleNamespace(total_upsample=256))

    def __init__(self):
        self.warm_threads = []

    def warmup(self):
        self.warm_threads.append(threading.current_thread().name)
        return 3

    def synthesize(self, text, seed=None, temperature=1.0, fused=None,
                   pcm16=False):
        return np.zeros(4, np.float32)

    def _chunk_long_text(self, text, max_phonemes):
        return [text]


def test_public_warmup_runs_on_the_device_thread():
    """``DynamicBatcher.warmup()`` is public as in JAX, and whoever calls
    it, the work runs on the device thread (PyTorch keeps cuDNN's plans per
    thread); before ``start()`` and after ``stop()`` it raises."""
    from iris_tts_tpu_torch.serve.batcher import (
        DynamicBatcher,
        ServerStoppedError,
    )

    stub = _WarmOnlyPipeline()
    b = DynamicBatcher(stub, max_wait_ms=1.0)
    with pytest.raises(RuntimeError, match="start"):
        b.warmup()
    assert stub.warm_threads == []
    b.start()
    try:
        assert b.warmup() == 3
        done = []
        t = threading.Thread(target=lambda: done.append(b.warmup()),
                             name="another-caller")
        t.start()
        t.join(timeout=60)
        assert done == [3]
        assert stub.warm_threads == ["tts-batcher"] * 3
        assert b.synthesize("still serving", timeout=60).shape == (4,)
    finally:
        b.stop()
    with pytest.raises(ServerStoppedError):
        b.warmup()


def _gan_states(cfg, periods, num_scales, width):
    from iris_tts_tpu_torch.models.discriminators import (
        HiFiGANDiscriminators,
    )
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from iris_tts_tpu_torch.models.layers import init_params
    from iris_tts_tpu_torch.train.state import TrainState, adam_clipped

    gen = HiFiGANGenerator(cfg.hifigan)
    disc = HiFiGANDiscriminators(periods, num_scales, width)
    for i, m in enumerate((gen, disc)):
        init_params(m, torch.Generator().manual_seed(i))
    tx = adam_clipped(1e-3, 1.0, b1=0.8, b2=0.99)
    return TrainState.create(gen, tx, 0), TrainState.create(disc, tx, 1)


def test_make_gan_steps_binds_jax_arguments_and_checks_the_discriminators():
    """JAX's positional form ``make_gan_steps(cfg, periods, num_scales,
    disc_width, accum_steps, compute_dtype, remat)`` binds each argument to
    JAX's parameter; the steps train discriminators that match them and
    refuse ones that do not."""
    from iris_tts_tpu_torch.config import AudioConfig, HiFiGANConfig, IrisConfig
    from iris_tts_tpu_torch.train.gan import make_gan_steps

    cfg = IrisConfig(
        audio=AudioConfig(n_fft=64, hop_length=8, win_length=64, n_mels=16),
        hifigan=HiFiGANConfig(
            in_channels=16, upsample_rates=(4, 2),
            upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
            resblock_kernel_sizes=(3,), resblock_dilations=((1,),)))
    bound = inspect.signature(make_gan_steps).bind(cfg, (2,), 1, 0.25, 2)
    assert bound.arguments == {"cfg": cfg, "periods": (2,), "num_scales": 1,
                               "disc_width": 0.25, "accum_steps": 2}
    rng = np.random.default_rng(0)
    batch = {"mel": torch.from_numpy(rng.standard_normal(
                 (2, 16, 16)).astype(np.float32)),
             "audio": torch.from_numpy(0.1 * rng.standard_normal(
                 (2, 128)).astype(np.float32))}
    gs, ds = _gan_states(cfg, (2,), 1, 0.25)
    d_step, g_step = make_gan_steps(cfg, (2,), 1, 0.25, 1, None, False)
    ds, dm = d_step(gs, ds, batch)
    gs, gm = g_step(gs, ds, batch)
    assert np.isfinite(float(dm["disc_loss"]))
    assert np.isfinite(float(gm["gen_total"]))
    for args in [((3,), 1, 0.25), ((2,), 2, 0.25), ((2,), 1, 1.0), ()]:
        d_bad, g_bad = make_gan_steps(cfg, *args)
        with pytest.raises(ValueError, match="make_gan_steps was given"):
            d_bad(gs, ds, batch)
        with pytest.raises(ValueError, match="make_gan_steps was given"):
            g_bad(gs, ds, batch)


def test_train_loop_takes_jax_fields_in_jax_order(tmp_path):
    """``TrainLoop(state, train_step, batcher, num_epochs, checkpoints,
    ...)`` binds as JAX's does (the device follows JAX's fields and
    defaults to the state's); ``eval_extras`` feeds the eval step;
    ``handle_signals=False`` leaves the signal handlers alone."""
    import signal

    from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
    from iris_tts_tpu_torch.train.loop import TrainLoop

    class _Batcher:
        def epoch(self, i):
            yield {"x": np.ones((2, 3), np.float32)}

    seen = {"train": [], "eval": []}

    def step(state, batch, k):
        seen["train"].append(k)
        state.step += 1
        return state, {"total": torch.tensor(1.0)}

    def eval_step(params, batch, k):
        seen["eval"].append(k)
        return {"total": torch.tensor(float(k))}

    ckpt = CheckpointManager(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    loop = TrainLoop(_linear_state(), step, _Batcher(), 2, ckpt, None,
                     eval_step, _Batcher(), lambda e: (e,),
                     lambda e: (10 + e,), prefetch=0,
                     uses_frozen_in_eval=False, handle_signals=False,
                     checkpoint_every=1)
    assert loop.checkpoints is ckpt and loop.device == torch.device("cpu")
    seen_handlers = []
    inner = loop._run

    def spy(state, stop):
        seen_handlers.append(signal.getsignal(signal.SIGTERM))
        return inner(state, stop)

    loop._run = spy
    state = loop.run()
    assert seen_handlers == [handler]
    assert seen == {"train": [0, 1], "eval": [10, 11]}
    assert state.step == 2 and ckpt.all_steps() == [1, 2]
