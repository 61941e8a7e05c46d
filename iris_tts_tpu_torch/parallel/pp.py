"""Two-stage pipeline-parallel synthesis: text→mel and mel→waveform on
disjoint groups of ranks.

Counterpart of the JAX package's ``parallel/pp.py``. Stage 1 is the fused
path's text→mel work (encoder, durations, budget compression, VAE, PostNet:
``models/pipeline.fused_mel``); stage 2 is the HiFiGAN vocoder. The first
``split`` ranks run stage 1 and the rest stage 2; each rank holds only its
own stage's parameters, and within a group the rows of each batch split
over the group's ranks (the batch pads to ``lcm(split, ranks − split)``).

Every rank runs the same program on the same batches, as everywhere in the
port. The mel crosses from stage 1 to stage 2 in an asynchronous
all-reduce into a zero-filled buffer (the collective both NCCL and gloo
take on the card, ``parallel/mesh.py``), so stage 1 computes batch N+1's
mel while stage 2 vocodes batch N, with at most ``inflight`` batches in
flight; the waveforms are gathered the same way, and every rank returns
the whole result.

For these model sizes replicating everything and splitting the batch
(``TTSPipeline.use_mesh``) is the throughput default; the split pays when a
stage outgrows one device's memory or the stages want different settings.
"""

from __future__ import annotations

from collections import deque
from math import lcm
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from iris_tts_tpu_torch.parallel.mesh import (
    broadcast_flat_,
    new_group,
    pad_rows,
    process_group_info,
    reduce_rows,
    unwiden,
)
from iris_tts_tpu_torch.runtime import DeviceLike

STAGE1_MODULES = ("encoder", "duration", "vae", "postnet")


class PipelineParallelSynthesizer:
    """Run a :class:`~iris_tts_tpu_torch.models.pipeline.TTSPipeline`'s two
    synthesis stages pipelined over two groups of ranks of the process
    group (which must have at least two).

    ``split`` is the number of stage-1 (text→mel) ranks, by default half;
    ``devices`` lists each rank's device (default: the pipeline's).
    ``params`` holds this rank's stage: the encoder, duration head, VAE and
    PostNet on a stage-1 rank, the vocoder alone on a stage-2 rank, each
    replicated from its group's first rank."""

    def __init__(
        self,
        pipe,
        devices: Optional[Sequence[DeviceLike]] = None,
        split: Optional[int] = None,
        inflight: int = 2,
    ):
        from iris_tts_tpu_torch.parallel.sharding import is_sharded

        if is_sharded(pipe.model):
            raise ValueError("the pipeline split is data-only (as JAX's): "
                             "give it a pipeline without a model axis")
        rank, world, backend = process_group_info()
        if world < 2:
            raise ValueError(
                f"pipeline parallelism needs >=2 processes, got {world}")
        k = split if split is not None else world // 2
        if not 1 <= k < world:
            raise ValueError(f"split={k} must leave both groups non-empty")
        self.pipe = pipe
        self.inflight = max(1, inflight)
        self.rank, self.world, self.split = rank, world, k
        self.backend = backend
        self.device = torch.device(devices[rank] if devices is not None
                                   else pipe.device)
        self.stage = 1 if rank < k else 2
        # Every rank creates both groups, in the same order.
        groups = (new_group(range(k)), new_group(range(k, world)))
        names = STAGE1_MODULES if self.stage == 1 else ("hifigan",)
        self.params = nn.ModuleDict(
            {n: getattr(pipe.model, n) for n in names}).to(self.device)
        tensors = [t.data for t in self.params.parameters()]
        tensors += [t.data for t in self.params.buffers()]
        broadcast_flat_(tensors, groups[self.stage - 1], backend,
                        "pp_replicate", src=0 if self.stage == 1 else k)
        self._batch_multiple = lcm(k, world - k)

    def _group_rows(self, bp: int):
        """(offset, rows) of this rank's block within its stage's group."""
        if self.stage == 1:
            per = bp // self.split
            return self.rank * per, per
        per = bp // (self.world - self.split)
        return (self.rank - self.split) * per, per

    # -- per-batch dispatch/collect -----------------------------------------

    def _dispatch(self, texts, seed, temperature, pcm16):
        from iris_tts_tpu_torch.models.pipeline import fused_mel, prior_noise

        pipe, cfg = self.pipe, self.pipe.config
        ids_np, lengths_np = pipe._encode_texts(texts)
        t_bucket = pipe._fused_frame_budget(lengths_np)
        seed_int = pipe._next_seed(seed)
        n = len(texts)
        ids_np = pad_rows(ids_np, self._batch_multiple)
        lengths_np = pad_rows(lengths_np, self._batch_multiple)
        bp = len(ids_np)
        mel_shape = (bp, t_bucket, cfg.hifigan.in_channels)
        mel = meta = None
        offset = 0
        if self.stage == 1:
            offset, rows = self._group_rows(bp)
            sl = slice(offset, offset + rows)
            ids = torch.from_numpy(ids_np[sl]).to(self.device)
            lengths = torch.from_numpy(lengths_np[sl]).to(self.device)
            # The whole batch's noise, as the fused path draws it.
            eps = pad_rows(prior_noise(
                n, cfg.vae.latent_dim, t_bucket, cfg.vae.down_factor,
                seed_int, self.device, pipe.dtype), self._batch_multiple)[sl]
            with torch.inference_mode():
                mel, n_frames, deficit = fused_mel(
                    self.params, ids, lengths, eps, temperature, t_bucket,
                    pipe.use_postnet, pipe.upsample)
            meta = torch.stack([n_frames.long(), deficit.long()], dim=1)
        mel_buf, mel_work = reduce_rows(
            mel, mel_shape, pipe.dtype, self.device, offset, None,
            self.backend, "pp_handoff", async_op=True)
        meta_buf, meta_work = reduce_rows(
            meta, (bp, 2), torch.int64, self.device, offset, None,
            self.backend, "pp_handoff", async_op=True)
        return mel_buf, mel_work, meta_buf, meta_work, n, bp, pcm16

    def _collect(self, disp):
        mel_buf, mel_work, meta_buf, meta_work, n, bp, pcm16 = disp
        mel_work.wait()
        meta_work.wait()
        pipe = self.pipe
        hop = pipe.config.hifigan.total_upsample
        dtype = torch.int16 if pcm16 else pipe.dtype
        audio, offset = None, 0
        if self.stage == 2:
            offset, rows = self._group_rows(bp)
            with torch.inference_mode():
                audio = pipe._maybe_pcm16(self.params["hifigan"](
                    mel_buf[offset:offset + rows]), pcm16)
        audio_buf, _ = reduce_rows(
            audio, (bp, mel_buf.shape[1] * hop), dtype, self.device, offset,
            None, self.backend, "pp_gather")
        meta = meta_buf.cpu().numpy()
        pipe._count_overflows(meta[:n, 1])
        audio_np = unwiden(audio_buf, dtype)[:n].cpu()
        audio_np = (audio_np.numpy() if pcm16
                    else audio_np.float().numpy())
        return [a[: int(f) * hop] for a, f in zip(audio_np, meta[:n, 0])]

    # -- public API ---------------------------------------------------------

    def synthesize(
        self,
        texts: Union[str, Sequence[str]],
        seed: Optional[int] = None,
        temperature: float = 1.0,
        pcm16: bool = False,
    ):
        """One batch through both stages (no overlap at depth 1: use
        :meth:`synthesize_batches` for streams). A bare string is one
        utterance and returns one waveform, as ``TTSPipeline.synthesize``
        does."""
        single = isinstance(texts, str)
        batch = [texts] if single else list(texts)
        out = self._collect(self._dispatch(batch, seed, temperature, pcm16))
        return out[0] if single else out

    def synthesize_batches(
        self,
        batches: Sequence[Sequence[str]],
        seed: Optional[int] = None,
        temperature: float = 1.0,
        pcm16: bool = False,
    ):
        """Pipeline a sequence of text batches; yields one list of
        waveforms per batch, in order, with at most ``inflight`` batches
        dispatched ahead of the collector."""
        if isinstance(batches, str):
            raise TypeError(
                "synthesize_batches takes a sequence of BATCHES; for one "
                "batch or one utterance use synthesize()")
        q = deque()
        for texts in batches:
            batch = [texts] if isinstance(texts, str) else list(texts)
            if len(q) == self.inflight:
                yield self._collect(q.popleft())
            q.append(self._dispatch(batch, seed, temperature, pcm16))
        while q:
            yield self._collect(q.popleft())
