"""The port's public surface against the JAX package's: each subpackage's
``__all__`` diffed against JAX's, with an explicit allowlist of the names
not ported yet (``ROADMAP.md`` §A) and of those left out on purpose.

A name leaves the allowlist when the port exports it (the test fails until
it is taken out), so the list only shrinks as slices land.
"""

import importlib
import pkgutil

import pytest
import torch

import iris_tts_tpu

# name → why the port does not export it (yet).
NOT_YET = {
    "utils": {
        "StepTimer": "read by nothing in the port",
        "profile_stats": "read by nothing in the port",
    },
}
# Subpackages the port does not have at all.
NO_PACKAGE = {}

SUBPACKAGES = [""] + sorted(m.name for m in pkgutil.iter_modules(
    iris_tts_tpu.__path__) if m.ispkg)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_what_jax_exports(sub):
    suffix = "." + sub if sub else ""
    jax_pkg = importlib.import_module("iris_tts_tpu" + suffix)
    jax_names = set(getattr(jax_pkg, "__all__", ()))
    if sub in NO_PACKAGE:
        with pytest.raises(ImportError):
            importlib.import_module("iris_tts_tpu_torch" + suffix)
        return
    port = importlib.import_module("iris_tts_tpu_torch" + suffix)
    port_names = set(getattr(port, "__all__", ()))
    allowed = set(NOT_YET.get(sub, {}))
    missing = jax_names - port_names - allowed
    assert not missing, f"the port's {sub or 'root'} lacks {sorted(missing)}"
    landed = allowed & port_names
    assert not landed, f"take {sorted(landed)} out of the allowlist"
    assert allowed <= jax_names, sorted(allowed - jax_names)
    for name in port_names:
        assert hasattr(port, name), name  # every exported name imports


def test_checkpoint_restore_best_and_resume_signature(tmp_path):
    """``CheckpointManager.restore_best(state_template)`` restores the best
    checkpoint (the latest when none is best), and ``resume_if_available``
    takes the JAX package's ``steps_per_epoch``."""
    from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
    from iris_tts_tpu_torch.train.loop import resume_if_available
    from iris_tts_tpu_torch.train.state import TrainState, adam_clipped

    def state(fill):
        m = torch.nn.Linear(3, 2)
        with torch.no_grad():
            for p in m.parameters():
                p.fill_(fill)
        return TrainState.create(m, adam_clipped(1e-3), 0)

    ckpt = CheckpointManager(tmp_path / "c")
    s = state(1.0)
    ckpt.save(1, s, val_metric=0.5)
    s2 = state(2.0)
    s2.step = 2
    ckpt.save(2, s2, val_metric=0.9)  # worse: not the best
    t = ckpt.restore_best(state(0.0))
    assert t.step == 0 and float(t.params.weight[0, 0]) == 1.0
    r, epoch = resume_if_available(ckpt, state(0.0), steps_per_epoch=10)
    assert r.step == 2 and float(r.params.weight[0, 0]) == 2.0
    assert epoch == 0
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "none").restore_best(state(3.0))



def test_stft_magnitude_matmul_matches_jax():
    """The one op the port newly exports, against JAX's on the same input:
    the magnitude the ``impl="xla"`` log-mel composes."""
    import jax.numpy as jnp
    import numpy as np

    import iris_tts_tpu.ops as jops
    import iris_tts_tpu_torch.ops as tops

    x = (0.3 * np.random.default_rng(0).standard_normal((2, 3000))).astype(
        np.float32)
    kw = dict(n_fft=256, hop_length=64, win_length=200)
    want = np.asarray(jops.stft_magnitude_matmul(jnp.asarray(x), **kw))
    got = tops.stft_magnitude_matmul(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 2e-4
