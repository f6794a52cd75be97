"""The batched one-shot path of the port against the JAX package:
``transcribe_samples_batched``, ``transcribe_samples_words``, the chunk
merge, ``decode_words`` and the CLI's ``--audio-list`` / ``--batch-files``
/ ``--timestamps``.

The tiny w8 model of ``tests/test_torch_model.py`` on both sides (JAX's
fused step under ``VOXTRAL_MEGAKERNEL=force``), the synthetic tekken.json
of ``tests/test_torch_pipeline.py``.  The buffers were chosen with every
top-2 logit margin of the port's run above 0.2 (the test asserts 0.1), so
a differing text would be a fault, not a near-tie.  The merge is decided
under JAX's own constants on both sides: JAX reads its module's, the
port is handed the same numbers as a ``MergeCost``.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voxtral_tpu.tokenizer import VoxtralTokenizer as JaxTokenizer

from tests.test_torch_model import (
    FINAL_NORM_GAIN,
    MIN_MARGIN,
    SCALE,
    SEED,
    dense_params,
    tiny_config,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_pipeline import tekken_json

MEL_FRAMES = 200  # 2 s chunks: the 4.5 s buffer takes three


def tone(secs, f1, f2, sr=16000):
    t = np.arange(int(secs * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * f1 * t)
            + 0.2 * np.sin(2 * np.pi * f2 * t)).astype(np.float32)


# Three buffers of one padded length (one resampled from 22.05 kHz), one
# of another, and one of three chunks (2 s, 2 s, 0.5 s).
BUFFERS = [(tone(1.5, 300, 900), 16000), (tone(1.95, 440, 1320), 16000),
           (tone(1.5, 520, 1560, 22050), 22050),
           (tone(4.5, 520, 1560), 16000), (tone(1.5, 250, 2000), 16000)]


@pytest.fixture(scope="module")
def tree():
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    return quantize_params_w8(dense_params(tiny_config(), SEED, SCALE,
                                           FINAL_NORM_GAIN))


def jax_merge_cost():
    """JAX's merge constants as the port's MergeCost."""
    from voxtral_tpu import pipeline as jp
    from voxtral_tpu_torch.pipeline import MergeCost

    return MergeCost(jp.STEP_COST_C0_MS, jp.STEP_COST_C1_MS,
                     jp.ENC_COST_PER_POS_MS)


@pytest.fixture(scope="module")
def pipes(tree):
    """(port pipeline, JAX pipeline) over the same tree, 2 s chunks."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.pipeline import PipelineConfig as JaxConfig
    from voxtral_tpu.pipeline import TranscribePipeline as JaxPipeline
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline
    from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

    cfg = tiny_config()
    port = TranscribePipeline(
        VoxtralModel.from_numpy(tree, cfg, "cpu"),
        VoxtralTokenizer.from_json(tekken_json()),
        PipelineConfig(max_mel_frames=MEL_FRAMES,
                       merge_cost=jax_merge_cost()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        ref = JaxPipeline(
            JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg),
            JaxTokenizer.from_json(tekken_json()),
            JaxConfig(max_mel_frames=MEL_FRAMES))
    return port, ref


def test_transcribe_samples_batched_matches_jax(pipes):
    port, ref = pipes
    model = port.model
    model.record_margins = model.measure_decode = True
    model.decode_log = []
    try:
        texts = port.transcribe_samples_batched(BUFFERS, batch_size=2)
        for samples, sr in BUFFERS:
            port.transcribe_samples(samples, sr)
            assert float(model.last_margins.min()) > MIN_MARGIN
    finally:
        model.record_margins = model.measure_decode = False
    # The 4.5 s buffer first, on its own path, its three chunks merged
    # into one batch (JAX's constants); then batches of at most 2 rows,
    # all dispatched before any fetch: the three 1.5 s buffers in two,
    # the 1.95 s one alone.
    assert [r["rows"] for r in model.decode_log[:4]] == [3, 2, 1, 1]
    assert all(t for t in texts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        want = ref.transcribe_samples_batched(BUFFERS, batch_size=2)
    assert texts == want


def test_batched_tokens_equal_each_buffer_alone(pipes):
    port, _ = pipes
    got = port.batched_chunk_tokens(BUFFERS, batch_size=8)
    for (samples, sr), chunks in zip(BUFFERS, got):
        alone = port._chunk_tokens(samples, sr)
        assert [c.tolist() for c in chunks] == [c.tolist() for c in alone]
    assert [len(c) for c in got] == [1, 1, 1, 3, 1]
    assert port.transcribe_samples_batched([]) == []
    with pytest.raises(ValueError, match="batch_size"):
        port.transcribe_samples_batched(BUFFERS, batch_size=0)


def test_merge_keeps_each_chunk_its_tokens(pipes):
    """Decode is causal: the 0.5 s chunk padded to the 2 s chunks' length
    keeps its tokens; the merge wins under JAX's constants and loses when
    no cost model is given."""
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    port, ref = pipes
    samples = BUFFERS[3][0]
    never = TranscribePipeline(port.model, port.tokenizer, PipelineConfig(
        max_mel_frames=MEL_FRAMES, merge_cost=None))
    model = port.model
    model.measure_decode, model.decode_log = True, []
    try:
        merged = port._chunk_tokens(samples, 16000)
        rows = [r["rows"] for r in model.decode_log]
        model.decode_log = []
        apart = never._chunk_tokens(samples, 16000)
        rows_apart = [r["rows"] for r in model.decode_log]
    finally:
        model.measure_decode = False
    assert rows == [3] and sorted(rows_apart) == [1, 2]
    assert [c.tolist() for c in merged] == [c.tolist() for c in apart]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        _, jchunks = ref._chunk_tokens(samples, 16000)
    assert [c.tolist() for c in merged] == [np.asarray(c).tolist()
                                            for c in jchunks]


def test_transcribe_samples_words_matches_jax(pipes):
    port, ref = pipes
    samples = BUFFERS[3][0]
    got = port.transcribe_samples_words(samples, 16000)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        want = ref.transcribe_samples_words(samples, 16000)
    assert got["words"] and got["text"]
    assert got == want
    # The words of the later chunks carry their chunk's start offset.
    assert got["words"][-1]["start"] >= 2.0


@pytest.mark.parametrize("delay_s,offset_s", [(0.48, 0.0), (0.0, 12.5)])
def test_decode_words_matches_jax(delay_s, offset_s):
    from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

    ids = [32, 33, 1004, 1005, 32, 32, 33, 1010, 32, 33, 1020, 1021, 1022,
           32, 32, 32, 33, 1007]
    got = VoxtralTokenizer.from_json(tekken_json()).decode_words(
        ids, delay_s=delay_s, offset_s=offset_s)
    want = JaxTokenizer.from_json(tekken_json()).decode_words(
        ids, delay_s=delay_s, offset_s=offset_s)
    assert got and got == want


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The tiny model as a SafeTensors directory (``--dtype w8`` loads
    the tree of the fixture above), and WAVs of BUFFERS[0], [1], [3]."""
    from voxtral_tpu.audio import AudioBuffer, save_wav

    from tests.test_torch_safetensors import write_model_dir

    root = tmp_path_factory.mktemp("batched")
    directory, _ = write_model_dir(root / "model")
    wavs = []
    for i in (0, 1, 3):
        path = root / f"b{i}.wav"
        save_wav(AudioBuffer(*BUFFERS[i]), path)
        wavs.append(str(path))
    return str(directory), wavs


def _cli(model_dir, *argv):
    return ["--model", model_dir, "--dtype", "w8", "--device", "cpu",
            "--max-mel-frames", str(MEL_FRAMES), *argv]


def test_cli_audio_list_batch_files(model_dir, tmp_path, capsys):
    from voxtral_tpu_torch import cli
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    directory, wavs = model_dir
    listing = tmp_path / "files.txt"
    listing.write_text("\n".join([wavs[0], "", wavs[1], "missing.wav",
                                  wavs[2]]) + "\n")
    rc = cli.main(_cli(directory, "--audio-list", str(listing),
                       "--batch-files", "2"))
    out = capsys.readouterr()
    assert rc == 1  # the missing file
    assert "audio file not found: missing.wav" in out.err
    lines = out.out.splitlines()
    assert len(lines) == 4 and lines[2] == ""
    pipe = TranscribePipeline.from_model_dir(
        directory, "w8", PipelineConfig(max_mel_frames=MEL_FRAMES),
        device="cpu")
    want = pipe.transcribe_files_batched(wavs, batch_size=2)
    assert [lines[0], lines[1], lines[3]] == want and all(want)
    # Without --batch-files the list is transcribed file by file.
    listing.write_text("\n".join(wavs) + "\n")
    assert cli.main(_cli(directory, "--audio-list", str(listing))) == 0
    assert capsys.readouterr().out.splitlines() == want


def test_cli_timestamps(model_dir, capsys):
    from voxtral_tpu_torch import cli
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    directory, wavs = model_dir
    rc = cli.main(_cli(directory, "--timestamps", "--audio", wavs[2],
                       "--audio", "missing.wav"))
    out = capsys.readouterr()
    assert rc == 1
    lines = out.out.splitlines()
    assert len(lines) == 2 and lines[1] == ""
    got = json.loads(lines[0])
    assert set(got) == {"file", "text", "words"}
    pipe = TranscribePipeline.from_model_dir(
        directory, "w8", PipelineConfig(max_mel_frames=MEL_FRAMES),
        device="cpu")
    assert got == {"file": wavs[2], **pipe.transcribe_file_words(wavs[2])}
    assert got["words"] and {"word", "start", "end"} <= set(got["words"][0])


@pytest.mark.parametrize("argv,msg", [
    (["--audio-list", "missing-list.txt"], "audio list not found"),
    (["--audio-list", "files.txt", "--audio", "x.wav"],
     "--audio conflicts with --audio-list"),
    (["--timestamps", "--batch-files", "2", "--audio", "x.wav"],
     "--timestamps is per-file"),
])
def test_cli_batch_flag_errors(argv, msg, capsys, tmp_path, monkeypatch):
    """Flag errors exit 2 before any model is built (as the JAX CLI)."""
    from voxtral_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    (tmp_path / "files.txt").write_text("x.wav\n")
    assert cli.main(["--random-weights", "--device", "cpu", *argv]) == 2
    assert msg in capsys.readouterr().err


@pytest.mark.cuda
def test_batched_layer_route_on_card(tree, monkeypatch):
    """On the card only: the batched path on the per-layer route (K7),
    kernels against their plain versions, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from voxtral_tpu_torch.models import voxtral as tvx
    from voxtral_tpu_torch.ops import decode_step as tdsp
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline
    from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

    monkeypatch.setattr(tvx, "oneshot_plan",
                        lambda model, batch, seq_len, spec=1: ("layer", "-"))
    cfg = tiny_config()
    dev = torch.device("cuda")
    model = tvx.VoxtralModel.from_numpy(tree, cfg, dev)
    plain = tvx.VoxtralModel(model.params, cfg, dev, kernels=False)
    tok = VoxtralTokenizer.from_json(tekken_json())
    pcfg = PipelineConfig(max_mel_frames=MEL_FRAMES)
    before = tdsp.decode_layer_step.launches
    got = TranscribePipeline(model, tok, pcfg).batched_chunk_tokens(BUFFERS)
    assert tdsp.decode_layer_step.launches > before
    want = TranscribePipeline(plain, tok, pcfg).batched_chunk_tokens(BUFFERS)
    assert [[c.tolist() for c in b] for b in got] == [
        [c.tolist() for c in b] for b in want]
