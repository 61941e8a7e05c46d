"""Port parity: the audio-quality measures and the synthesis meter of
``iris_tts_tpu_torch.utils.metrics`` against the JAX package's on the same
seeded arrays (host-side numpy in float64 in both)."""

import math

import numpy as np
import pytest

import iris_tts_tpu.utils.metrics as jm
import iris_tts_tpu_torch.utils.metrics as tm


def _mels(seed, ta=37, tb=29, n_mels=16):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((ta, n_mels)) - 4.0).astype(np.float32)
    b = (rng.standard_normal((tb, n_mels)) - 4.0).astype(np.float32)
    return a, b


def test_mel_cepstra_matches_jax():
    a, _ = _mels(0)
    for n in (5, 13):
        np.testing.assert_allclose(tm.mel_cepstra(a, n), jm.mel_cepstra(a, n),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("align", ["trim", "dtw"])
@pytest.mark.parametrize("seed", [1, 2])
def test_distances_and_report_match_jax(align, seed):
    a, b = _mels(seed)
    got_mcd = tm.mel_cepstral_distortion(a, b, align=align)
    want_mcd = jm.mel_cepstral_distortion(a, b, align=align)
    assert abs(got_mcd - want_mcd) <= 1e-12
    got_lsd = tm.log_spectral_distance(a, b, align=align)
    assert abs(got_lsd - jm.log_spectral_distance(a, b, align=align)) <= 1e-12
    got, want = tm.quality_report(a, b, align), jm.quality_report(a, b, align)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert got_mcd > 0 and got_lsd > 0


def test_dtw_path_equal_to_jax():
    rng = np.random.default_rng(3)
    cost = rng.random((23, 31))
    ga, gb = tm.dtw_path(cost)
    wa, wb = jm.dtw_path(cost)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gb, wb)
    # a monotonic path from (0, 0) to the far corner
    assert (ga[0], gb[0]) == (0, 0) and (ga[-1], gb[-1]) == (22, 30)
    assert (np.diff(ga) >= 0).all() and (np.diff(gb) >= 0).all()


def test_empty_input_is_nan():
    a, _ = _mels(4)
    empty = np.zeros((0, a.shape[1]), np.float32)
    for align in ("trim", "dtw"):
        assert math.isnan(tm.mel_cepstral_distortion(a, empty, align=align))
        assert math.isnan(tm.log_spectral_distance(empty, a, align=align))
        report = tm.quality_report(empty, a, align)
        assert all(math.isnan(v) for v in report.values())
        assert all(math.isnan(v) for v in jm.quality_report(
            empty, a, align).values())


def test_synthesis_meter_summary_equal(monkeypatch):
    """Both meters driven by the same start/stop sequence on the same fake
    clock report the same summary."""
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 4.0, 10.0, 10.1]
    stops = [22050, 11025, 44100, 256 * 7]

    def drive(module):
        clock = iter(ticks)
        monkeypatch.setattr(module, "time",
                            type("Clock", (), {"time": lambda: next(clock)}))
        meter = module.SynthesisMeter(22050, 256)
        for n in stops:
            meter.start()
            meter.stop(n)
        return meter.summary()

    got, want = drive(tm), drive(jm)
    assert got == want
    assert got["audio_seconds"] == pytest.approx(sum(stops) / 22050)
    assert got["p50_latency_s"] == pytest.approx(0.5)
    assert tm.SynthesisMeter().summary() == jm.SynthesisMeter().summary()
