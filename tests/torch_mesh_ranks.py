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
        env = dict(os.environ, WORLD_SIZE=str(n), OMP_NUM_THREADS="2",
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


def run_train_case(case: dict, mesh=None) -> dict:
    """One training case → {"params": state dict(s) after the steps,
    "metrics": each step's metrics}. ``case``: ``stage`` (duration, vae,
    postnet or gan), ``config`` (JSON), ``modules`` (initial state
    dicts), ``batches`` (numpy, one a step), ``lr``, ``clip``,
    ``accum_steps``. On a ``mesh`` the state is replicated and each rank
    steps on its rows (``scripts.common.mesh_training_placement``)."""
    from iris_tts_tpu_torch.config import config_from_json
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
    metrics = []
    for batch in case["batches"]:
        if accum > 1:
            batch = tsteps.split_microbatches(batch, accum)
        b = (place(batch) if place is not None
             else {k: torch.from_numpy(v) for k, v in batch.items()})
        state, m = step(state, b, *extras)
        metrics.append({k: float(v) for k, v in m.items()})
    if stage == "gan":
        params = {"gen": state.gen.params.state_dict(),
                  "disc": state.disc.params.state_dict()}
    else:
        params = state.params.state_dict()
    return {"params": params, "metrics": metrics}


def train(workdir: Path) -> dict:
    """Every case of ``workdir/train_cases.pt`` as this rank of the mesh."""
    from iris_tts_tpu_torch.parallel import build_mesh
    from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES, world_size

    cases = torch.load(workdir / "train_cases.pt", weights_only=False)
    mesh = build_mesh(devices=["cpu"] * world_size())
    out = {name: run_train_case(case, mesh) for name, case in cases.items()}
    out["collectives"] = dict(COLLECTIVES)
    return out


SCENARIOS = {"synth": synth, "train": train}


def main() -> None:
    scenario, workdir = sys.argv[1], Path(sys.argv[2])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(2)
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
