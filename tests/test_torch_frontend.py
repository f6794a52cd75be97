"""The port's own copies of the JAX package's framework-free modules —
``config``, ``tokenizer`` and ``audio`` (numpy log-mel, pad, chunk,
resample, WAV io) — against the originals.  They are copies, so every
output must be equal: bit-equal arrays, field-equal configs, equal text.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from voxtral_tpu import audio as jaudio
from voxtral_tpu import config as jconfig
from voxtral_tpu import tokenizer as jtok
from voxtral_tpu_torch import audio as taudio
from voxtral_tpu_torch import config as tconfig
from voxtral_tpu_torch import tokenizer as ttok

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _signal(seconds: float, sr: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.size)
    return sig.astype(np.float32)


@pytest.mark.parametrize("name", ["params.json", "params_tiny.json"])
def test_config_from_file_matches_jax(name):
    got = tconfig.VoxtralConfig.from_file(FIXTURES / name)
    ref = jconfig.VoxtralConfig.from_file(FIXTURES / name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tconfig.VoxtralConfig.voxtral()) == \
        dataclasses.asdict(jconfig.VoxtralConfig.voxtral())


@pytest.mark.parametrize("seconds", [0.5, 2.3])
def test_log_mel_is_bit_equal(seconds):
    sig = _signal(seconds, 16000)
    got = taudio.MelSpectrogram.voxtral().compute_log_batch(sig)
    ref = jaudio.MelSpectrogram.voxtral().compute_log_batch(sig)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert taudio.MelSpectrogram.voxtral().num_frames(len(sig)) == \
        jaudio.MelSpectrogram.voxtral().num_frames(len(sig))


def test_pad_chunk_and_resample_are_bit_equal():
    sig = _signal(3.1, 22050, seed=1)
    got = taudio.resample_to_16k(taudio.AudioBuffer(sig.copy(), 22050))
    ref = jaudio.resample_to_16k(jaudio.AudioBuffer(sig.copy(), 22050))
    assert got.sample_rate == ref.sample_rate == 16000
    np.testing.assert_array_equal(got.samples, ref.samples)

    got.peak_normalize(0.95)
    ref.peak_normalize(0.95)
    np.testing.assert_array_equal(got.samples, ref.samples)
    tp = taudio.pad_audio(got, taudio.PadConfig.voxtral())
    jp = jaudio.pad_audio(ref, jaudio.PadConfig.voxtral())
    np.testing.assert_array_equal(tp.samples, jp.samples)
    assert taudio.num_audio_tokens(len(sig)) == jaudio.num_audio_tokens(len(sig))

    long = _signal(9.0, 16000, seed=2)
    tcfg = taudio.ChunkConfig.voxtral().with_max_frames(200).with_overlap(10)
    jcfg = jaudio.ChunkConfig.voxtral().with_max_frames(200).with_overlap(10)
    tch, jch = taudio.chunk_audio(long, tcfg), jaudio.chunk_audio(long, jcfg)
    assert len(tch) == len(jch) == taudio.num_chunks(len(long), tcfg) > 1
    for a, b in zip(tch, jch):
        assert (a.start_sample, a.end_sample) == (b.start_sample, b.end_sample)
        np.testing.assert_array_equal(a.samples, b.samples)
    assert taudio.needs_chunking(len(long), tcfg) == \
        jaudio.needs_chunking(len(long), jcfg)


def test_wav_round_trip(tmp_path):
    sig = _signal(0.7, 22050, seed=3)
    path = tmp_path / "x.wav"
    taudio.save_wav(taudio.AudioBuffer(sig, 22050), path)
    got = taudio.load_wav(path)
    ref = jaudio.load_wav(path)
    assert got.sample_rate == ref.sample_rate == 22050
    np.testing.assert_array_equal(got.samples, ref.samples)
    # 16-bit PCM on disk, written at x 32767 and read back at / 32768:
    # one quantization step plus the 1/32768 scale difference.
    np.testing.assert_allclose(got.samples, sig, rtol=2.0 / 32768,
                               atol=1.0 / 32767)


def test_tokenizer_decode_matches_jax():
    from tests.test_torch_pipeline import tekken_json

    text = tekken_json(50)
    got = ttok.VoxtralTokenizer.from_json(text)
    ref = jtok.VoxtralTokenizer.from_json(text)
    # Text ids start at 1000 + the four control entries of the vocab.
    ids = [1, 32, 1004, 1010, 33, 1049, 5]
    assert got.decode(ids) == ref.decode(ids) == "w0 w6 w45 "
    assert got.vocab_size == ref.vocab_size
    assert (ttok.BOS_TOKEN, ttok.STREAMING_PAD) == \
        (jtok.BOS_TOKEN, jtok.STREAMING_PAD)
