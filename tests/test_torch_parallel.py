"""The port's ``parallel/`` package in one process: the mesh of a lone
process (1×1, no collectives) and of a one-rank process group (every
collective called), its errors, and the paths that must be bitwise the
off-mesh ones there (after ``tests/test_parallel.py``). The multi-rank
checks are in ``tests/test_torch_parallel_{synth,train,cli}.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from iris_tts_tpu_torch.config import MeshConfig
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
from iris_tts_tpu_torch.parallel import (
    build_mesh,
    data_sharding,
    initialize_multihost,
    replicate_params,
    replicated,
    shard_batch,
)
from iris_tts_tpu_torch.parallel.mesh import (
    COLLECTIVES,
    Mesh,
    any_rank,
    barrier,
    local_rows,
    pad_rows,
)
from iris_tts_tpu_torch.parallel.sharding import (
    batch_sharding_tree,
    tp_param_sharding,
)
from iris_tts_tpu_torch.scripts.common import (
    mesh_from_args,
    mesh_training_placement,
)
from iris_tts_tpu_torch.train import stages
from tests import torch_mesh_ranks as R
from tests.test_torch_parallel_train import _duration_batch
from tests.torch_port_utils import port_config, small_config

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _two_rank_view(rank=1):
    """A 2-rank mesh as rank ``rank`` sees it, for the row arithmetic that
    makes no collective call."""
    return Mesh({"data": 2, "model": 1}, ("data", "model"), rank, CPU)


def test_build_mesh_shapes_and_errors():
    mesh = build_mesh(MeshConfig(), ["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert mesh.size == 1 and mesh.group is None and mesh.device == CPU
    named = build_mesh(MeshConfig(data_axis="batch", model_axis="tp"),
                       ["cpu"])
    assert named.shape == {"batch": 1, "tp": 1}
    with pytest.raises(ValueError, match="does not cover"):
        build_mesh(MeshConfig(data_parallel=3), ["cpu"])
    with pytest.raises(ValueError, match="one device per rank"):
        build_mesh(MeshConfig(), ["cpu", "cpu"])
    # a model axis of two does not cover a lone process
    with pytest.raises(ValueError, match="does not cover"):
        build_mesh(MeshConfig(model_parallel=2), ["cpu"])


def test_build_mesh_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh()


def test_initialize_multihost_is_a_no_op_without_a_launcher(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    initialize_multihost()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="both"):
        initialize_multihost("127.0.0.1:1234")
    assert not dist.is_initialized()


def test_placement_on_a_one_rank_mesh():
    mesh = build_mesh(MeshConfig(), ["cpu"])
    batch = {"x": np.arange(16.0).reshape(16, 1), "y": torch.ones(16, 2)}
    for placed in (shard_batch(batch, mesh), batch_sharding_tree(batch, mesh)):
        np.testing.assert_array_equal(placed["x"].numpy(), batch["x"])
        assert placed["y"].device == CPU
    assert data_sharding(mesh).axis == 0 and replicated(mesh).axis is None
    lin = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in lin.state_dict().items()}
    assert replicate_params(lin, mesh) is lin
    assert tp_param_sharding(lin, mesh) is lin
    for k, v in lin.state_dict().items():
        assert torch.equal(v, before[k])
    # a model axis without a process group raises: no fallback to
    # replication
    with pytest.raises(ValueError, match="needs a process group"):
        tp_param_sharding(lin, Mesh({"data": 1, "model": 2},
                                    ("data", "model"), 0, CPU))


def test_rows_of_a_rank_and_pad_rows():
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(local_rows(x, _two_rank_view(1)), x[3:])
    t = torch.arange(8).reshape(2, 4)
    assert torch.equal(local_rows(t, _two_rank_view(0), axis=1), t[:, :2])
    with pytest.raises(ValueError, match="does not divide"):
        local_rows(np.zeros((5, 2)), _two_rank_view())
    padded = pad_rows(np.arange(5), 4)
    np.testing.assert_array_equal(padded, [0, 1, 2, 3, 4, 4, 4, 4])
    assert torch.equal(pad_rows(torch.tensor([[1], [2]]), 3),
                       torch.tensor([[1], [2], [2]]))


@pytest.fixture(scope="module")
def pipes():
    cfg = port_config(small_config())
    pipe = TTSPipeline.initialize(cfg, seed=3, device="cpu")
    with torch.no_grad():  # audible audio at this width
        for n, p in pipe.model.hifigan.named_parameters():
            if n.endswith("weight"):
                p.mul_(15.0)
    buckets = dict(phoneme_buckets=(16, 32, 64),
                   frame_buckets=(16, 32, 64, 128, 256, 512))
    off = dataclasses.replace(pipe, **buckets)
    on = dataclasses.replace(pipe, **buckets).use_mesh(
        build_mesh(MeshConfig(), ["cpu"]))
    return off, on


@pytest.mark.parametrize("fused", [True, False])
def test_use_mesh_on_one_rank_is_bitwise_off_mesh(pipes, fused):
    off, on = pipes
    assert on._mesh is not None and off._mesh is None
    want = off.synthesize(R.PIPE_TEXTS, seed=11, temperature=0.667,
                          fused=fused)
    got = on.synthesize(R.PIPE_TEXTS, seed=11, temperature=0.667,
                        fused=fused)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        on.synthesize_mel("Hello world.", seed=2),
        off.synthesize_mel("Hello world.", seed=2))


def test_use_mesh_rejects_a_foreign_mesh(pipes):
    off, _ = pipes
    foreign = build_mesh(MeshConfig(data_axis="batch"), ["cpu"])
    with pytest.raises(ValueError, match="lack"):
        dataclasses.replace(off).use_mesh(foreign)


def test_vocode_sharded_on_one_rank_is_vocode(pipes):
    """One rank: ``vocode_sharded`` is the plain ``vocode`` (bitwise), and
    its PCM16 the host quantization of it."""
    _, on = pipes
    mels = R.vocode_mels(on.config.hifigan.in_channels)
    for t in R.VOCODE_LENGTHS:
        np.testing.assert_array_equal(on.vocode_sharded(mels[t]),
                                      on.vocode(mels[t]))
    np.testing.assert_array_equal(
        on.vocode_sharded(mels["pcm16"], pcm16=True),
        host_pcm16(on.vocode(mels["pcm16"])))
    off_mesh = dataclasses.replace(pipes[0])
    np.testing.assert_array_equal(off_mesh.vocode_sharded(mels[200]),
                                  off_mesh.vocode(mels[200]))


def test_mesh_training_on_one_rank_is_bitwise(tmp_path):
    """Three duration steps (dropout on) through
    ``mesh_training_placement`` on a 1×1 mesh equal the plain steps
    bitwise: no collective runs and every draw is the plain draw."""
    from tests.test_torch_parallel_train import _cases

    case = dict(_cases()[0]["duration"])
    want = R.run_train_case(case)
    got = R.run_train_case(case, build_mesh(MeshConfig(), ["cpu"]))
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["metrics"] == want["metrics"]


def test_mesh_training_needs_a_dividing_batch(tmp_path):
    """A training batch must divide over the data axis: a stage refuses
    one that does not before it touches anything, and so does the
    placement of a batch."""
    cfg = port_config(small_config())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             batch_size=3))
    with pytest.raises(ValueError, match="batch_size=3 does not divide"):
        stages.duration_stage(cfg, tmp_path, tmp_path, tmp_path,
                              mesh=_two_rank_view())
    _, place = mesh_training_placement(
        R.sgd_state(torch.nn.Linear(2, 2), 0.1, 0),
        mesh=build_mesh(MeshConfig(), ["cpu"]))
    assert place(_duration_batch(np.random.default_rng(0), rows=3))[
        "phoneme_ids"].shape[0] == 3
    view = _two_rank_view()
    with pytest.raises(ValueError, match="does not divide"):
        local_rows(_duration_batch(np.random.default_rng(0), rows=3)[
            "phoneme_ids"], view)


def test_model_parallel_flag_raises(monkeypatch):
    """What still raises: ``--model_parallel`` without ``--mesh``, and a
    model axis that does not cover the world (two in a lone process)."""
    import argparse

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_from_args(argparse.Namespace(mesh=True, model_parallel=2), CPU)
    with pytest.raises(ValueError, match="needs --mesh"):
        mesh_from_args(argparse.Namespace(mesh=False, model_parallel=2), CPU)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone, destroyed after the
    test; yields its mesh."""
    initialize_multihost(f"file://{tmp_path}/store", 1, 0, device="cpu",
                         timeout_s=60)
    try:
        yield build_mesh(MeshConfig(), ["cpu"])
    finally:
        dist.destroy_process_group()


def test_one_rank_process_group_calls_every_collective_bitwise(
        pipes, one_rank_group):
    """With a process group, a one-rank mesh still calls its collectives
    (an all-reduce of one rank into a zero buffer is exact), so the mesh
    paths run on the backend at world size 1; each stays bitwise the
    off-mesh path: synthesis fused and two-stage, three steps of each
    stage (BatchNorm's global statistics and the GAN round included), the
    barrier and the host-agreed stop flag."""
    from tests.test_torch_parallel_train import _cases

    mesh = one_rank_group
    assert mesh.size == 1 and mesh.group is not None
    assert mesh.backend == "gloo"
    COLLECTIVES.clear()
    off = pipes[0]
    on = dataclasses.replace(off).use_mesh(mesh)
    for fused in (True, False):
        want = off.synthesize(R.PIPE_TEXTS, seed=11, temperature=0.667,
                              fused=fused)
        got = on.synthesize(R.PIPE_TEXTS, seed=11, temperature=0.667,
                            fused=fused)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    cases = _cases()[0]
    for name in ("duration", "vae", "postnet", "gan"):
        want = R.run_train_case(dict(cases[name]))
        got = R.run_train_case(dict(cases[name]), mesh)
        flat = (lambda p: {f"{s}.{k}": v for s, sd in p.items()
                           for k, v in sd.items()}) if name == "gan" else (
            lambda p: p)
        for k, v in flat(want["params"]).items():
            assert torch.equal(flat(got["params"])[k], v), (name, k)
        assert got["metrics"] == want["metrics"], name
    barrier(mesh)
    assert any_rank(True, mesh, "stop_flag")
    assert not any_rank(False, mesh, "stop_flag")
    paths = {path for (path, _, _) in COLLECTIVES}
    assert {"use_mesh", "frame_bucket", "replicate", "gradients",
            "loss_denominator", "batch_norm_stats", "metrics", "barrier",
            "stop_flag"} <= paths
    assert {b for (_, _, b) in COLLECTIVES} == {"gloo"}
