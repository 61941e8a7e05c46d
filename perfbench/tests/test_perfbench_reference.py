"""The traffic generator is the seed's alone, and the benchmark's frozen
reference (frontend, reader, model) agrees with the port on the CPU."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference.frontend import Frontend, read_lexicon
from perfbench.reference.model import (
    SynthesisModel,
    durations_from_log,
    length_regulate,
    state_dict_from_flax,
)
from perfbench.traffic.ljspeech_text import Generator

ROOT = Path(__file__).resolve().parents[2]
TINY = Path(__file__).resolve().parent / "tiny"
TRAFFIC = json.loads((ROOT / "perfbench/workloads/ljspeech-bulk.json")
                     .read_text())
SEED = 2**31 + 4099


@pytest.fixture(scope="module")
def lexicon():
    return read_lexicon()


def test_generator_is_deterministic_by_seed(lexicon):
    a = Generator(TRAFFIC, SEED, lexicon)
    b = Generator(TRAFFIC, SEED, lexicon)
    c = Generator(TRAFFIC, SEED + 1, lexicon)
    ja = [a.job(), a.job()]
    assert ja == [b.job(), b.job()]
    assert ja[0] != c.job()
    assert ja[0] != ja[1]  # every job is new
    assert len(ja[0]) == TRAFFIC["utterances_per_job"]


def test_generator_gives_every_seed_the_same_sizes(lexicon):
    def shapes(job):
        return Counter(tuple(len(lexicon[w.strip(",.").lower()])
                             for w in t.split()) for t in job)

    a, b = Generator(TRAFFIC, 1, lexicon), Generator(TRAFFIC, SEED, lexicon)
    first = shapes(a.job())
    assert first == shapes(a.job()) == shapes(b.job())
    lo, hi = TRAFFIC["words_per_utterance"]
    assert {len(s) for s in first} == set(range(lo, hi + 1))


def test_generator_emits_only_short_lexicon_words(lexicon):
    for text in Generator(TRAFFIC, SEED, lexicon).job():
        words = text.rstrip(".").replace(",", "").lower().split()
        for w in words:
            assert w in lexicon, w
            assert len(lexicon[w]) <= TRAFFIC["max_phonemes_per_word"], w
        assert text.endswith(".") and text[0].isupper()


def test_frontend_matches_the_port(lexicon):
    from iris_tts_tpu_torch.text.frontend import create_text_processor
    from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

    vocab_path = ROOT / "release/pipeline_artifact/vocab.json"
    port = create_text_processor(neural_g2p=False)
    port_vocab = PhonemeVocab.load(vocab_path)
    ref = Frontend(lexicon, json.loads(vocab_path.read_text()))
    for text in Generator(TRAFFIC, SEED, lexicon).job()[:64]:
        assert np.array_equal(ref.ids(text),
                              port.text_to_ids(text, port_vocab))


def test_reader_matches_the_port():
    from iris_tts_tpu_torch.convert.orbax import read_tree as port_read

    from perfbench.reference.model import flat_leaves
    from perfbench.reference.reader.orbax import read_tree

    path = ROOT / "release/pipeline_artifact/params"
    ours = dict(flat_leaves(read_tree(path)))
    theirs = dict(flat_leaves(port_read(path)))
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        assert np.array_equal(v, theirs[k]), k


def test_model_matches_the_port_on_seeded_weights():
    """At a tiny width on the CPU: stage A's log-durations, the mel after
    the prior sample and the PostNet, and the waveform."""
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline

    cfg = weights.load_config("tiny", TINY / "configs/tiny.json")
    tree = weights.parameter_tree(cfg, SEED, torch.device("cpu"))
    pipe = weights.program_pipeline(cfg, tree, torch.device("cpu"))
    assert isinstance(pipe, TTSPipeline)
    ref = SynthesisModel(cfg["model"])
    ref.load_state_dict(state_dict_from_flax(tree, ref))
    ref.eval()
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(2, 40, (3, 32), generator=g)
    lengths = torch.tensor([32, 20, 9])
    valid = torch.arange(32)[None] < lengths[:, None]
    ids = torch.where(valid, ids, 0)
    with torch.inference_mode():
        enc, frames, _ = pipe._stage_a_device(ids.numpy(), lengths.numpy())
        r_enc = ref.encoder(ids, valid)
        r_dur = durations_from_log(ref.duration(r_enc)) * valid
        assert torch.equal(frames, r_dur)
        t = 128
        disp = pipe._stage_b(enc, frames, t, 77, 1.0, False, 3,
                             return_mel=True)
        z = torch.randn((3, 4, t // 4), generator=torch.Generator()
                        .manual_seed(77))
        mel = ref.postnet(ref.vae.generate(length_regulate(r_enc, r_dur, t),
                                           z))
        audio = ref.hifigan(mel)
    torch.testing.assert_close(disp.mel, mel, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(disp.audio, audio, rtol=1e-5, atol=1e-6)
