"""The port's pipeline and CLI: WAV -> resample -> mel -> model -> text.

The tiny w8 model of tests/test_torch_model.py and a synthetic
tekken.json; the text must equal the JAX pipeline's on the same WAV.
"""

import base64
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from voxtral_tpu.audio import AudioBuffer, save_wav
from voxtral_tpu.tokenizer import VoxtralTokenizer

from tests.test_torch_model import (
    FINAL_NORM_GAIN,
    MIN_MARGIN,
    SCALE,
    SEED,
    dense_params,
    tiny_config,
)


def tekken_json(n_text: int = 300) -> str:
    """Control tokens + ``n_text`` text tokens "w<i> " (ids 1000 + i)."""
    vocab = [{"rank": r, "token_str": s, "is_control": True}
             for r, s in [(0, "<unk>"), (1, "<s>"), (32, "[STREAMING_PAD]"),
                          (33, "[STREAMING_WORD]")]]
    vocab += [{"rank": 1000 + len(vocab),
               "token_bytes": base64.b64encode(f"w{i} ".encode()).decode(),
               "is_control": False} for i in range(n_text)]
    return json.dumps({"config": {"default_vocab_size": 131072,
                                  "default_num_special_tokens": 1000},
                       "vocab": vocab})


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """1.5 s two-tone at 22.05 kHz (the pipeline resamples to 16 kHz)."""
    sr = 22050
    t = np.arange(int(1.5 * sr)) / sr
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.2 * np.sin(2 * np.pi * 1320 * t)).astype(np.float32)
    path = tmp_path_factory.mktemp("audio") / "tone.wav"
    save_wav(AudioBuffer(sig, sr), path)
    return path


@pytest.fixture(scope="module")
def tree():
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    return quantize_params_w8(dense_params(tiny_config(), SEED, SCALE,
                                           FINAL_NORM_GAIN))


def test_pipeline_text_matches_jax(tree, wav, monkeypatch):
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.pipeline import TranscribePipeline as JaxPipeline
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    cfg = tiny_config()
    tok = VoxtralTokenizer.from_json(tekken_json())
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    model.record_margins = True
    text = TranscribePipeline(model, tok).transcribe_file(wav)
    assert text.strip(), "expected text tokens from this configuration"
    margin = float(model.last_margins.min())
    assert margin > MIN_MARGIN, f"near-tie: top-2 margin {margin:.4f}"

    monkeypatch.setenv("VOXTRAL_MEGAKERNEL", "force")
    jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    assert text == JaxPipeline(jmodel, tok).transcribe_file(wav)


def test_pipeline_chunks_and_buckets(tree):
    from voxtral_tpu.audio import PadConfig
    from voxtral_tpu_torch.models.voxtral import PREFIX_LEN, VoxtralModel
    from voxtral_tpu_torch.pipeline import (
        SAMPLES_PER_POSITION,
        MergeCost,
        PipelineConfig,
        TranscribePipeline,
        pad_audio_bucketed,
    )

    cfg = tiny_config()
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    pipe = TranscribePipeline(model, VoxtralTokenizer.from_json(tekken_json()),
                              PipelineConfig(max_mel_frames=200,
                                             merge_cost=None))
    sig = np.sin(np.arange(int(4.5 * 16000)) * 0.05).astype(np.float32)
    chunks = pipe._chunk_tokens(sig, 16000)
    assert len(chunks) == 3  # 450 mel frames at 200 per chunk
    for toks, p in zip(chunks, pipe.padded_chunks(sig, 16000)):
        assert toks.dtype == np.int32 and len(toks) > 0
        assert len(p.samples) % (8 * SAMPLES_PER_POSITION) == 0
    padded = pad_audio_bucketed(AudioBuffer(sig[:8000], 16000),
                                PadConfig.voxtral(), 8)
    assert len(padded.samples) % (8 * SAMPLES_PER_POSITION) == 0
    n = model.decoder_seq_len(pipe.mel.num_frames(len(padded.samples)))
    assert n - PREFIX_LEN > 0
    assert pipe.decode_tokens(np.array([32, 1004, 1, 1005])) == "w0 w1 "

    # A cost model that favours one batch pads the short final chunk with
    # silence; decode is causal, so every chunk keeps its tokens.
    merged = TranscribePipeline(
        model, pipe.tokenizer,
        PipelineConfig(max_mel_frames=200,
                       merge_cost=MergeCost(c0_ms=10.0, c1_ms=0.0,
                                            enc_per_pos_ms=0.0)))
    assert merged._merge_wins({1: [0, 1], 2: [2]}, [30, 30, 20])
    for a, b in zip(merged._chunk_tokens(sig, 16000), chunks):
        assert a.tolist() == b.tolist()


def test_cli_help(capsys):
    from voxtral_tpu_torch import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--random-weights" in out and "--max-mel-frames" in out


@pytest.mark.parametrize("argv", [
    ["--batch-files", "8", "--timestamps"], ["--tp", "2"],
    ["--timestamps", "--tp", "2"], ["--audio-list", "list.txt"],
    ["--server", "http://localhost:1", "--random-weights"], ["--dp", "2"],
    ["--platform", "cpu"],
])
def test_cli_refuses_what_is_not_ported(argv, capsys, wav):
    """Flags not ported exit 2 naming their ROADMAP item; the ported
    batch flags refuse what the JAX CLI refuses (``--timestamps`` with
    ``--batch-files``, ``--audio`` with ``--audio-list``, ``--server``
    with local weights), and ``--tp`` / ``--dp`` a mesh larger than the
    cards, also exit 2."""
    from voxtral_tpu_torch import cli

    rc = cli.main(["--audio", str(wav), *argv])
    assert rc == 2
    err = capsys.readouterr().err
    if any(flag in argv for flag in cli._NOT_PORTED):
        assert "ROADMAP" in err
    elif "--server" in argv:
        assert "--random-weights conflicts with --server" in err
    elif "--tp" in argv or "--dp" in argv:
        # A mesh of 2 on fewer cards (none here): the JAX CLI's refusal.
        assert "needs 2 devices, found" in err
    elif "--audio-list" in argv:
        assert "--audio conflicts with --audio-list" in err
    else:
        assert "--timestamps is per-file" in err


def test_cli_random_weights_end_to_end(wav, capsys):
    from voxtral_tpu_torch import cli

    rc = cli.main(["--random-weights", "--dtype", "w8", "--device", "cpu",
                   "--params", "tests/fixtures/params_tiny.json",
                   "--audio", str(wav), "--audio", "missing.wav"])
    out = capsys.readouterr()
    assert rc == 1  # the missing file
    assert "audio file not found: missing.wav" in out.err
    assert len(out.out.splitlines()) == 2


def test_pipeline_speculative_gives_the_sequential_text(tree, wav):
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    model = VoxtralModel.from_numpy(tree, tiny_config(), "cpu")
    tok = VoxtralTokenizer.from_json(tekken_json())
    seq = TranscribePipeline(model, tok).transcribe_file(wav)
    assert seq.strip()
    for draft in ("ngram", "pad"):
        spec = TranscribePipeline(
            model, tok, PipelineConfig(speculative=4, draft=draft))
        assert spec.transcribe_file(wav) == seq
        assert model.last_spec_passes >= 1


def test_cli_speculative_end_to_end(wav, capsys):
    from voxtral_tpu_torch import cli

    argv = ["--random-weights", "--device", "cpu",
            "--params", "tests/fixtures/params_tiny.json",
            "--audio", str(wav)]
    assert cli.main(argv) == 0
    seq = capsys.readouterr().out
    rc = cli.main([*argv, "--speculative", "4", "--draft-policy", "pad"])
    assert rc == 0
    assert capsys.readouterr().out == seq
    assert len(seq.splitlines()) == 1


def test_cli_without_a_card_needs_device_cpu(wav, capsys, monkeypatch):
    """--device defaults to cuda: no card, no silent CPU fallback."""
    import torch

    from voxtral_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--random-weights", "--audio", str(wav)])
    assert rc == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert cli.main(["--random-weights", "--device", "tpu9",
                     "--audio", str(wav)]) == 2
