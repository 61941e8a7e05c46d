"""The ranks of the port's multi-device tests (``tests/test_torch_parallel*.py``).

A test writes its inputs into a work directory, then starts ``n`` gloo
ranks on the CPU with :func:`start_ranks`; each rank runs

    python -m tests.torch_mesh_ranks SCENARIO WORKDIR

joins the process group through a file store in WORKDIR (with a timeout),
runs the scenario and writes its results to ``WORKDIR/rank{r}.pt``. The
test computes its references meanwhile, then :meth:`Ranks.join` waits for
the ranks (at most a deadline; every rank still running is killed on a
failure or at the deadline) and returns their results. One group runs all
the checks of a test module.

This module imports torch and the port only, never JAX: the JAX values are
computed in the test's own process.
"""

from __future__ import annotations

import contextlib
import copy
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 60.0  # a collective waits at most this long


class Ranks:
    """Running rank processes; :meth:`join` collects them."""

    def __init__(self, scenario: str, workdir: Path, n: int,
                 deadline_s: float):
        self.workdir = Path(workdir)
        self.n = n
        self.deadline = time.monotonic() + deadline_s
        # four CPU threads for the group in all (two ranks: two each), so
        # a group leaves the test run's other workers their cores
        env = dict(os.environ, WORLD_SIZE=str(n),
                   OMP_NUM_THREADS=str(max(1, 4 // n)),
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), os.environ.get("PYTHONPATH", "")]))
        self.logs = [open(self.workdir / f"rank{r}.log", "w")
                     for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_mesh_ranks", scenario,
             str(self.workdir)], cwd=REPO,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        self.seconds = None
        self._t0 = time.monotonic()

    def _tail(self, r: int) -> str:
        self.logs[r].flush()
        return (self.workdir / f"rank{r}.log").read_text()[-3000:]

    def join(self) -> list:
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(f"rank {bad[0]} exited with "
                                       f"{codes[bad[0]]}:\n{self._tail(bad[0])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError("ranks outlived their deadline:\n"
                                       + self._tail(0))
                time.sleep(0.02)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in self.logs:
                f.close()
        self.seconds = time.monotonic() - self._t0
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(self.n)]


def start_ranks(scenario: str, workdir: Path, n: int = 2,
                deadline_s: float = 120.0) -> Ranks:
    return Ranks(scenario, workdir, n, deadline_s)


# -- shared inputs -------------------------------------------------------------

PIPE_TEXTS = ["Hello world.", "The quick brown fox jumps over the lazy dog.",
              "Speech!", "A mesh of two ranks.", "Padding row here."]
PP_BATCHES = [["hello world", "pipeline parallel"],
              ["the quick brown fox", "jumps over", "the lazy dog", "again"],
              ["single"]]
VOCODE_LENGTHS = (200, 203, 230)


def vocode_mels(n_mels: int) -> dict:
    rng = np.random.default_rng(7)
    mels = {t: rng.standard_normal((t, n_mels)).astype(np.float32)
            for t in VOCODE_LENGTHS}
    mels["pcm16"] = rng.standard_normal((160, n_mels)).astype(np.float32)
    mels["short"] = rng.standard_normal((8, n_mels)).astype(np.float32)
    return mels


# -- scenarios (one rank's side) -------------------------------------------------


def synth(workdir: Path) -> dict:
    """use_mesh (fused and two-stage, a pad row), vocode_sharded and the
    pipeline split, on the pipeline saved in ``workdir/pipe``."""
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.parallel import PipelineParallelSynthesizer
    from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES

    pipe = TTSPipeline.load(workdir / "pipe", device="cpu")
    pipe.use_mesh()
    out = {
        "staged": pipe.synthesize(PIPE_TEXTS, seed=11, temperature=0.667,
                                  fused=False),
        "fused": pipe.synthesize(PIPE_TEXTS, seed=12, temperature=0.667,
                                 fused=True),
        "staged_t0": pipe.synthesize(PIPE_TEXTS, temperature=0.0,
                                     fused=False),
        "fused_t0": pipe.synthesize(PIPE_TEXTS, temperature=0.0, fused=True),
        "mel_t0": pipe.synthesize_mel(PIPE_TEXTS[:3], temperature=0.0),
    }
    mels = vocode_mels(pipe.config.hifigan.in_channels)
    for t in VOCODE_LENGTHS:
        out[f"vocode_{t}"] = pipe.vocode_sharded(mels[t])
    out["vocode_pcm16"] = pipe.vocode_sharded(mels["pcm16"], pcm16=True)
    out["vocode_short"] = pipe.vocode_sharded(mels["short"])
    out["vocode_batch"] = pipe.vocode_sharded(np.stack([mels[200]] * 2))

    # every rank warms the same shapes (a rank that skipped one would hang
    # the other in its gather)
    out["warmup"] = (pipe.warmup_fused(max_phonemes=20, batch_sizes=(1, 3)),
                     pipe.warmup_batched((3,), max_frames_per_phoneme=2))

    pp = PipelineParallelSynthesizer(pipe, split=1, inflight=2)
    out["pp_keys"] = sorted(pp.params.state_dict())
    out["pp_batches"] = list(pp.synthesize_batches(PP_BATCHES, seed=3))
    out["pp_pcm16"] = pp.synthesize(["quantized on device"], seed=1,
                                    pcm16=True)
    out["pp_single"] = pp.synthesize("hello world", seed=3)
    out["collectives"] = dict(COLLECTIVES)
    return out


# -- training: each case on one process (mesh None) or as one rank ----------------

TRAIN_STEPS = 3


def sgd_state(module, lr: float, seed: int, frozen=None, clip=None):
    """A train state with plain SGD (the updates are linear in the
    gradients, so a float-ulp difference in a gradient stays one in the
    params) and optional global-norm clipping."""
    from iris_tts_tpu_torch.train.state import TrainState, Tx

    st = TrainState.create(module, Tx(lr, clip_norm=clip), seed,
                           frozen=frozen)
    st.optimizer = torch.optim.SGD(module.parameters(), lr=lr)
    return st


def _modules(cfg, sds: dict):
    from iris_tts_tpu_torch.models.discriminators import (
        HiFiGANDiscriminators,
    )
    from iris_tts_tpu_torch.models.encoder import (
        DurationPredictor,
        PhonemeEncoder,
    )
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from iris_tts_tpu_torch.models.postnet import PostNet
    from iris_tts_tpu_torch.models.vae import TextConditionedVAE

    build = {
        "duration": lambda: torch.nn.ModuleDict({
            "encoder": PhonemeEncoder(cfg.encoder),
            "duration": DurationPredictor(cfg.encoder.embed_dim,
                                          cfg.duration)}),
        "encoder": lambda: PhonemeEncoder(cfg.encoder),
        "vae": lambda: TextConditionedVAE(cfg.vae),
        "postnet": lambda: PostNet(cfg.postnet),
        "gen": lambda: HiFiGANGenerator(cfg.hifigan),
        "disc": lambda: HiFiGANDiscriminators((2,), 1, 0.125),
    }
    out = {}
    for name, sd in sds.items():
        m = build[name]()
        m.load_state_dict(sd)
        out[name] = m
    return out


@contextlib.contextmanager
def captured_gradients(out: list):
    """Within the block every ``TrainState.apply_gradients`` appends the
    gradients it applies (after the data-axis sum, before clipping), each
    whole (a sharded leaf's slices gathered over the model axis), keyed
    by parameter name."""
    from iris_tts_tpu_torch.parallel.sharding import sharded_params, whole
    from iris_tts_tpu_torch.train import state as tstate

    real_apply = tstate.TrainState.apply_gradients

    def apply(self):
        box = {}
        real_sum = tstate.all_reduce_flat_

        def summed(tensors, mesh, path):
            n = real_sum(tensors, mesh, path)
            box["grads"] = [t.detach().clone() for t in tensors]
            return n

        tstate.all_reduce_flat_ = summed
        try:
            real_apply(self)
        finally:
            tstate.all_reduce_flat_ = real_sum
        names = [n for n, p in self.params.named_parameters()
                 if p.requires_grad]
        split = sharded_params(self.params)
        out.append({n: whole(self.params, n, g) if n in split else g
                    for n, g in zip(names, box["grads"])})
        return self

    tstate.TrainState.apply_gradients = apply
    try:
        yield
    finally:
        tstate.TrainState.apply_gradients = real_apply


@contextlib.contextmanager
def without_input_gradient_sum():
    """A planted fault, for a training check's power only: the model
    axis' input-gradient sum does nothing within the block."""
    from iris_tts_tpu_torch.parallel import tp

    real = tp.input_grad_sum_
    tp.input_grad_sum_ = lambda grad, axis: grad
    try:
        yield
    finally:
        tp.input_grad_sum_ = real


def run_train_case(case: dict, mesh=None, fault: bool = False) -> dict:
    """One training case → {"params": whole state dict(s) after the steps,
    "metrics": each step's metrics, "grads": each update's whole
    gradients}. ``case``: ``stage`` (duration, vae, postnet or gan),
    ``config`` (JSON), ``modules`` (initial state dicts), ``batches``
    (numpy, one a step), ``lr``, ``clip``, ``accum_steps``. On a ``mesh``
    the state is placed (replicated, and sharded on a model axis) and each
    rank steps on its rows (``scripts.common.mesh_training_placement``);
    ``fault`` plants out the model axis' input-gradient sum."""
    from iris_tts_tpu_torch.config import config_from_json
    from iris_tts_tpu_torch.parallel.sharding import full_state_dict
    from iris_tts_tpu_torch.scripts.common import mesh_training_placement
    from iris_tts_tpu_torch.train import steps as tsteps
    from iris_tts_tpu_torch.train.gan import GANState, make_gan_train_step

    cfg = config_from_json(case["config"])
    mods = _modules(cfg, case["modules"])
    lr, clip, accum = case["lr"], case.get("clip"), case.get("accum_steps", 1)
    stage = case["stage"]
    if stage == "gan":
        state = GANState(sgd_state(mods["gen"], lr, 5, clip=clip),
                         sgd_state(mods["disc"], lr, 6, clip=clip))
        step = make_gan_train_step(cfg, accum)
    else:
        trained = {"duration": "duration", "vae": "vae",
                   "postnet": "postnet"}[stage]
        frozen = {k: v for k, v in mods.items() if k != trained} or None
        state = sgd_state(mods[trained], lr, 5, frozen=frozen, clip=clip)
        make = {"duration": lambda: tsteps.make_duration_train_step(
                    cfg, accum),
                "vae": lambda: tsteps.make_vae_train_step(cfg, accum),
                "postnet": lambda: tsteps.make_postnet_train_step(cfg)}
        step = make[stage]()
    extras = (case["kl_weight"],) if stage == "vae" else ()
    place = None
    if mesh is not None:
        state, place = mesh_training_placement(state, accum, mesh=mesh)
    metrics, grads = [], []
    with captured_gradients(grads), (without_input_gradient_sum() if fault
                                     else contextlib.nullcontext()):
        for batch in case["batches"]:
            if accum > 1:
                batch = tsteps.split_microbatches(batch, accum)
            b = (place(batch) if place is not None
                 else {k: torch.from_numpy(v) for k, v in batch.items()})
            state, m = step(state, b, *extras)
            metrics.append({k: float(v) for k, v in m.items()})
    if stage == "gan":
        params = {"gen": full_state_dict(state.gen.params),
                  "disc": full_state_dict(state.disc.params)}
    else:
        params = full_state_dict(state.params)
    return {"params": params, "metrics": metrics, "grads": grads}


def train(workdir: Path) -> dict:
    """Every case of ``workdir/train_cases.pt`` as this rank of the mesh."""
    from iris_tts_tpu_torch.parallel import build_mesh
    from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES, world_size

    cases = torch.load(workdir / "train_cases.pt", weights_only=False)
    mesh = build_mesh(devices=["cpu"] * world_size())
    out = {name: run_train_case(case, mesh) for name, case in cases.items()}
    out["collectives"] = dict(COLLECTIVES)
    return out


# -- the model axis: a 2×2 (data, model) mesh of four ranks ------------------

TP_MESH = dict(data_parallel=2, model_parallel=2)
GATE_TEXT = "The old gardener found a basket of apples."


def tp_mesh():
    from iris_tts_tpu_torch.config import MeshConfig
    from iris_tts_tpu_torch.parallel import build_mesh
    from iris_tts_tpu_torch.parallel.mesh import world_size

    return build_mesh(MeshConfig(**TP_MESH), ["cpu"] * world_size())


def tp_state(case: dict, adam: bool = False):
    """The duration case's train state (SGD, or Adam with clipping)."""
    from iris_tts_tpu_torch.config import config_from_json
    from iris_tts_tpu_torch.train.state import TrainState, adam_clipped

    cfg = config_from_json(case["config"])
    module = _modules(cfg, case["modules"])["duration"]
    if adam:
        return TrainState.create(module, adam_clipped(1e-3), 5)
    return sgd_state(module, case["lr"], 5)


def tp_adam_steps(state, case: dict, steps: int) -> None:
    """``steps`` duration steps of ``state`` on the case's first batch (this
    rank's rows of it on a placed state)."""
    from iris_tts_tpu_torch.config import config_from_json
    from iris_tts_tpu_torch.parallel.mesh import local_rows
    from iris_tts_tpu_torch.train.steps import make_duration_train_step

    step = make_duration_train_step(config_from_json(case["config"]))
    batch = case["batches"][0]
    if state.mesh is not None:
        batch = {k: local_rows(v, state.mesh) for k, v in batch.items()}
    for _ in range(steps):
        step(state, {k: torch.as_tensor(v) for k, v in batch.items()})


def tp(workdir: Path) -> dict:
    """The model axis on a 2×2 mesh: the sharded leaf sets, a sharded
    matmul, ``use_mesh`` (fused, two-stage, mel, warmups, bf16),
    ``vocode_sharded`` over both axes, the production HiFiGAN, each
    stage's SGD steps (with and without the input-gradient sum), Adam's
    moments and checkpoints both ways."""
    import dataclasses

    from iris_tts_tpu_torch.config import HiFiGANConfig
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from iris_tts_tpu_torch.models.layers import Dense, init_params
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.parallel.mesh import (
        COLLECTIVES,
        gather_rows,
        local_rows,
    )
    from iris_tts_tpu_torch.parallel.sharding import (
        full_state_dict,
        sharded_params,
        tp_param_sharding,
    )
    from iris_tts_tpu_torch.runtime import seeded_generator
    from iris_tts_tpu_torch.train.checkpoint import CheckpointManager

    mesh = tp_mesh()
    out = {"shape": mesh.shape, "coords": (mesh.rank, mesh.model_rank)}

    # JAX's :66, a matmul: rows over data, output columns over model
    mm = torch.load(workdir / "matmul.pt", weights_only=False)
    dense = Dense(16, 32)
    dense.load_state_dict(mm["dense"])
    tp_param_sharding(dense, mesh)
    out["matmul_weight_shape"] = tuple(dense.weight.shape)
    with torch.no_grad():
        out["matmul"] = gather_rows(dense(local_rows(mm["x"], mesh)), mesh)

    pipe = TTSPipeline.load(workdir / "pipe", device="cpu").use_mesh(mesh)
    out["pipe_sharded"] = sorted(sharded_params(pipe.model))
    out["pipe_bytes"] = sum(p.numel() * p.element_size()
                            for p in pipe.model.parameters())
    out.update({
        "staged": pipe.synthesize(PIPE_TEXTS, seed=11, temperature=0.667,
                                  fused=False),
        "fused": pipe.synthesize(PIPE_TEXTS, seed=12, temperature=0.667,
                                 fused=True),
        "staged_t0": pipe.synthesize(PIPE_TEXTS, temperature=0.0,
                                     fused=False),
        "fused_t0": pipe.synthesize(PIPE_TEXTS, temperature=0.0, fused=True),
        "mel_t0": pipe.synthesize_mel(PIPE_TEXTS[:3], temperature=0.0),
    })
    mels = vocode_mels(pipe.config.hifigan.in_channels)
    for t in VOCODE_LENGTHS:
        out[f"vocode_{t}"] = pipe.vocode_sharded(mels[t])
    out["vocode_pcm16"] = pipe.vocode_sharded(mels["pcm16"], pcm16=True)
    out["warmup"] = (pipe.warmup_fused(max_phonemes=20, batch_sizes=(1, 3)),
                     pipe.warmup_batched((3,), max_frames_per_phoneme=2))
    # a pipeline sharing the model before use_mesh keeps the whole one
    base = TTSPipeline.load(workdir / "pipe", device="cpu")
    other = dataclasses.replace(base).use_mesh(mesh)
    out["shared_model_kept_whole"] = not sharded_params(base.model) and bool(
        sharded_params(other.model))

    p16 = TTSPipeline.load(workdir / "pipe_plain", device="cpu",
                           dtype="bf16").use_mesh(mesh)
    out["bf16"] = p16.synthesize(GATE_TEXT, seed=7, temperature=0.0,
                                 return_mel=True)

    # JAX's :162, the production HiFiGAN (512 initial channels)
    gen = HiFiGANGenerator(HiFiGANConfig())
    init_params(gen, seeded_generator(0, "cpu"))
    tp_param_sharding(gen, mesh)
    out["hifigan_sharded"] = sorted(sharded_params(gen))
    hg_mel = torch.load(workdir / "hifigan_mel.pt")
    with torch.no_grad():
        out["hifigan"] = gather_rows(gen(local_rows(hg_mel, mesh)), mesh)
    del gen

    # each stage: three SGD steps, and the same without the input-gradient
    # sum (planted)
    cases = torch.load(workdir / "train_cases.pt", weights_only=False)
    for name, case in cases.items():
        out[name] = run_train_case(case, mesh)
        out[f"{name}_fault"] = run_train_case(case, mesh, fault=True)
    dur = cases["duration"]
    st = tp_state(dur)
    st.place_on(mesh)
    out["duration_state_sharded"] = sorted(sharded_params(st.params))
    gan = cases["gan"]
    from iris_tts_tpu_torch.config import config_from_json

    gmods = _modules(config_from_json(gan["config"]), gan["modules"])
    for side in ("gen", "disc"):
        tp_param_sharding(gmods[side], mesh)
        out[f"gan_{side}_sharded"] = sorted(sharded_params(gmods[side]))

    # Adam: moments are slices; a checkpoint is whole tensors both ways
    st = tp_state(dur, adam=True).place_on(mesh)
    tp_adam_steps(st, dur, 1)
    moments = {}
    for key, (layer, pname) in sharded_params(st.params).items():
        p = getattr(layer, pname)
        moments[key] = (tuple(p.shape),
                        tuple(st.optimizer.state[p]["exp_avg"].shape),
                        tuple(st.optimizer.state[p]["exp_avg_sq"].shape))
    out["adam_moments"] = moments
    ck = CheckpointManager(workdir / "ckpt_tp", mesh=mesh)
    ck.save(1, st)
    out["ckpt_tp_state"] = copy.deepcopy(st.state_dict())  # not views
    tp_adam_steps(st, dur, 1)
    out["ckpt_tp_next"] = full_state_dict(st.params)
    back = tp_state(dur, adam=True)
    back.place_on(mesh)
    CheckpointManager(workdir / "ckpt_one", mesh=mesh).restore(back)
    out["ckpt_one_restored"] = back.state_dict()
    out["collectives"] = dict(COLLECTIVES)
    return out


def serve(workdir: Path) -> dict:
    """``python -m iris_tts_tpu_torch.serve --mesh`` as this rank (its
    ``main``, in this process, whose group is up already), with the
    arguments of ``workdir/serve_args.json``: rank 0 serves until it is
    interrupted, the other ranks follow it until it stops them."""
    import json

    from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES
    from iris_tts_tpu_torch.serve.__main__ import main as serve_main

    serve_main(json.loads((workdir / "serve_args.json").read_text()))
    return {"collectives": dict(COLLECTIVES)}


SCENARIOS = {"synth": synth, "train": train, "tp": tp, "serve": serve}


def main() -> None:
    scenario, workdir = sys.argv[1], Path(sys.argv[2])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    from iris_tts_tpu_torch.parallel import initialize_multihost

    initialize_multihost(f"file://{workdir}/store", world, rank,
                         device="cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        result = SCENARIOS[scenario](workdir)
        tmp = workdir / f"rank{rank}.pt.tmp"
        torch.save(result, tmp)
        os.replace(tmp, workdir / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
