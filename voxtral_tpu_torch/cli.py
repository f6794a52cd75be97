"""Transcribe CLI of the port.

Usage:
    python -m voxtral_tpu_torch.cli --model DIR --dtype bfloat16 --audio x.wav
    python -m voxtral_tpu_torch.cli --model DIR --dtype w8 \
        --params-cache cache/ --audio x.wav
    python -m voxtral_tpu_torch.cli --random-weights --dtype w8 --audio x.wav
    python -m voxtral_tpu_torch.cli --random-weights --speculative 8 \
        --draft-policy ngram --audio x.wav
    python -m voxtral_tpu_torch.cli --gguf model.gguf --tokenizer \
        tekken.json --weight-format q4g --audio x.wav
    python -m voxtral_tpu_torch.cli --model DIR --dtype w8 \
        --audio-list files.txt --batch-files 8
    python -m voxtral_tpu_torch.cli --model DIR --timestamps --audio x.wav
    python -m voxtral_tpu_torch.cli --server http://127.0.0.1:8080 \
        --audio x.wav

Ported so far: ``--audio`` (repeatable) or ``--audio-list FILE`` (one
path per line; the two conflict), ``--batch-files N`` (decode the files
in batches of up to N rows, one text line per file in order),
``--timestamps`` (one JSON line per file, ``{"file", "text", "words"}``;
per file, so not with ``--batch-files``), ``--model DIR`` (a SafeTensors
model directory: consolidated.safetensors, params.json, tekken.json),
``--dtype {bfloat16,float32,w8}`` (default bfloat16, as in the JAX CLI;
with ``--model`` or ``--random-weights``), ``--random-weights``,
``--gguf`` with ``--weight-format {q4,q4g,w8}`` (default w8, as in the
JAX CLI; a ``params.json`` beside the file or ``--params`` sets the
architecture), ``--params``, ``--params-cache DIR`` (the converted tree
of ``--model --dtype w8`` and of ``--gguf``, cached on disk),
``--delay``, ``--max-mel-frames``, ``--tokenizer``, ``--speculative``,
``--draft-policy``, ``--device`` (default ``cuda``; without a card it
exits with an error, and the CPU runs the kernels' plain versions only
when asked for with ``--device cpu``) and ``--tp`` / ``--dp`` (w8
weights, or ``--gguf --weight-format q4g``, or bf16 weights at ``--tp
1``: a ``(dp, tp)`` mesh over the cards, tensor- and data-parallel
decode; bf16 at ``--tp`` > 1 and float32 on any mesh exit with an error
naming ROADMAP item 12.3b; more shards than cards exit with an error,
as the JAX CLI; with ``--device cpu`` the mesh's shards share the CPU,
for tests) and ``--server URL`` (transcribe through a running server,
:mod:`voxtral_tpu_torch.serving`, with no weights here; not with
``--gguf``, ``--random-weights``, ``--batch-files``, ``--tp`` or
``--dp``, as the JAX CLI).  ``--platform`` of ``voxtral_tpu/cli.py`` is
recognised and exits with an error: the port takes ``--device``.  One
line of text per audio file on stdout (a missing file prints an empty
line and the exit code is 1); logs on stderr.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

# flag -> (value it takes when unset, ROADMAP item that ports it)
_NOT_PORTED = {
    "--platform": (None, "none: the port takes --device instead"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="voxtral-transcribe-torch",
        description="Transcribe audio with Voxtral Mini 4B Realtime "
        "(PyTorch + CUDA port)",
    )
    p.add_argument("-a", "--audio", action="append", default=[],
                   help="Path to a WAV file; repeatable")
    p.add_argument("--audio-list", metavar="FILE",
                   help="Text file with one WAV path per line (instead of "
                   "--audio)")
    p.add_argument("--batch-files", type=int, default=0, metavar="N",
                   help="Decode the files in batches of up to N rows (files "
                   "of one padded length share each decode step)")
    p.add_argument("--timestamps", action="store_true",
                   help="One JSON line per file with word-level start / end "
                   "times: {\"file\", \"text\", \"words\"}")
    p.add_argument("--model", metavar="DIR",
                   help="SafeTensors model directory "
                   "(consolidated.safetensors, params.json, tekken.json)")
    p.add_argument("--random-weights", action="store_true",
                   help="Random weights at the configuration's shapes, in "
                   "--dtype (no model download)")
    p.add_argument("--gguf", metavar="PATH",
                   help="Q4_0 GGUF checkpoint (needs --tokenizer)")
    p.add_argument("--weight-format", choices=["q4", "q4g", "w8"],
                   default="w8",
                   help="GGUF path: q4 keeps packed int4 (per-op decode, "
                   "the K3 kernel); q4g keeps exact Q4_0 codes + f16 group "
                   "scales (the fused step in group-32 mode); w8 "
                   "requantizes to rowwise int8 at load (default)")
    p.add_argument("--params",
                   help="params.json overriding the architecture "
                   "(with --random-weights or --gguf)")
    p.add_argument("--dtype", choices=["bfloat16", "float32", "w8"],
                   default="bfloat16",
                   help="--model / --random-weights weights: bfloat16 (the "
                   "fused step with bf16 weights), float32 (the per-op "
                   "step in f32) or w8 (rowwise int8, requantized at load)")
    p.add_argument("--params-cache", metavar="DIR",
                   help="Directory caching converted weight trees (--model "
                   "--dtype w8, --gguf): the first load pays the "
                   "requantization / repack, later loads read the cache")
    p.add_argument("-d", "--delay", type=float, default=6.0,
                   help="Delay in tokens (1 token = 80 ms); default 6")
    p.add_argument("--max-mel-frames", type=int, default=3000,
                   help="Max mel frames per chunk")
    p.add_argument("--tokenizer", help="Tokenizer JSON path (tekken.json)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="Verify K drafted tokens per decode weight pass "
                   "(greedy; the same tokens, fewer passes when drafts "
                   "hit)")
    p.add_argument("--draft-policy", choices=["ngram", "pad"],
                   default="ngram",
                   help="Speculative draft source: ngram = bigram table "
                   "trained on the device by every pass; pad = constant "
                   "[STREAMING_PAD] drafts")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel ways: the decoder's heads, FFN "
                   "rows and the 131k-vocab lm_head split over the mesh's "
                   "model axis (w8 or q4g weights, not bf16 or float32; "
                   "needs tp x dp cards)")
    p.add_argument("--server", metavar="URL",
                   help="Transcribe through a running server "
                   "(http://host:port, voxtral-serve-torch or the JAX "
                   "package's) instead of loading weights here; with "
                   "--audio / --audio-list and --timestamps")
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel ways: batched chunk rows split over "
                   "the mesh's data axis (w8, q4g or bf16 weights, not "
                   "float32; needs tp x dp cards)")
    for flag, (default, _) in _NOT_PORTED.items():
        p.add_argument(flag, nargs="?", const=True, default=default,
                       help=argparse.SUPPRESS)
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


class ArgError(Exception):
    """A refused argument or a model that cannot load: the message goes
    to stderr and the exit code is 2."""


def device_and_mesh(args):
    """(device, mesh or None) of ``--device``, ``--tp`` and ``--dp``."""
    import torch

    try:
        device = torch.device(args.device)
    except RuntimeError as exc:
        raise ArgError(f"--device {args.device}: {exc}") from None
    if args.tp < 1 or args.dp < 1:
        raise ArgError("--tp/--dp must be >= 1")
    if args.tp * args.dp == 1:
        return device, None
    from voxtral_tpu_torch.parallel import make_mesh

    n = args.tp * args.dp
    if device.type == "cuda":
        n_dev = torch.cuda.device_count()
        if n > n_dev:
            raise ArgError(f"--tp {args.tp} x --dp {args.dp} needs {n} "
                           f"devices, found {n_dev}")
        mesh = make_mesh(args.dp, args.tp)
    else:  # a mesh whose shards share the one device (tests)
        mesh = make_mesh(args.dp, args.tp, [device] * n)
    logging.getLogger("voxtral_tpu_torch").info(
        "mesh: %d data x %d model over %s", args.dp, args.tp, mesh.devices)
    return mesh.first, mesh


def load_pipeline(args, pcfg, device, mesh):
    """The pipeline of ``--random-weights`` (in ``--dtype``), ``--gguf``
    (in ``--weight-format``) or ``--model`` (in ``--dtype``) on
    ``device`` / ``mesh``; the CLI's and the server's."""
    import torch

    from voxtral_tpu_torch.config import VoxtralConfig
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    if device.type == "cuda" and not torch.cuda.is_available():
        raise ArgError(f"--device {args.device}: no CUDA device is available "
                       "(torch.cuda.is_available() is False); pass --device "
                       "cpu to run the plain PyTorch versions on the CPU")
    if args.random_weights:
        from voxtral_tpu_torch.models.voxtral import VoxtralModel
        from voxtral_tpu_torch.tokenizer import VoxtralTokenizer
        from voxtral_tpu_torch.utils.quantize import (
            random_dense_params,
            random_w8_params,
        )

        cfg = (VoxtralConfig.from_file(args.params) if args.params
               else VoxtralConfig.voxtral())
        logging.getLogger("voxtral_tpu_torch").info(
            "random %s weights (seed 0) on %s", args.dtype, device)
        try:
            if args.dtype == "w8":
                model = VoxtralModel.from_numpy(random_w8_params(cfg), cfg,
                                                device, mesh=mesh)
            else:
                dtype = getattr(torch, args.dtype)
                model = VoxtralModel(
                    random_dense_params(cfg, 0, dtype, device), cfg, device,
                    mesh=mesh)
        except ValueError as exc:  # what a mesh cannot take
            raise ArgError(str(exc)) from None
        if args.tokenizer:
            tokenizer = VoxtralTokenizer.from_file(args.tokenizer)
        else:
            tokenizer = VoxtralTokenizer(
                [None] * 131072, {1: "<s>", 32: "[STREAMING_PAD]"}, 131072)
        return TranscribePipeline(model, tokenizer, pcfg)
    if args.gguf:
        if not Path(args.gguf).exists():
            raise ArgError(f"GGUF file not found: {args.gguf}")
        cfg = VoxtralConfig.from_file(args.params) if args.params else None
        try:
            return TranscribePipeline.from_gguf(
                args.gguf, args.tokenizer, pcfg, config=cfg,
                weight_format=args.weight_format, device=device,
                params_cache=args.params_cache, mesh=mesh)
        except (ValueError, EOFError, KeyError) as exc:
            raise ArgError(f"failed to load GGUF model: {exc}") from None
    model_dir = Path(args.model)
    if not (model_dir / "consolidated.safetensors").exists():
        raise ArgError(f"model not found at {model_dir} (expected "
                       "consolidated.safetensors)")
    try:
        return TranscribePipeline.from_model_dir(
            model_dir, args.dtype, pcfg, params_cache=args.params_cache,
            device=device, mesh=mesh)
    except (FileNotFoundError, ValueError, KeyError) as exc:
        raise ArgError(
            f"failed to load the model directory: {exc}") from None


def _run_remote(args, audio_paths: list[str]) -> int:
    """--server mode: a thin client over :mod:`voxtral_tpu_torch.client`
    (stdlib HTTP; no model, no card) with the same per-file output and
    exit codes as local decoding."""
    from voxtral_tpu_torch.client import ServerError, VoxtralClient

    try:
        client = VoxtralClient(args.server)
    except ValueError as e:
        return _error(str(e))
    status = 0
    for path in audio_paths:
        if not Path(path).exists():
            print(f"error: audio file not found: {path}", file=sys.stderr)
            status = 1
            print("")
            continue
        try:
            result = client.transcribe(path, timestamps=args.timestamps)
        except (ServerError, OSError) as e:
            print(f"error: transcription failed for {path}: {e}",
                  file=sys.stderr)
            status = 1
            print("")
            continue
        if args.timestamps:
            print(json.dumps({"file": str(path), "text": result["text"],
                              "words": result.get("words", [])}),
                  flush=True)
        else:
            print(result["text"], flush=True)
    return status


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    for flag, (default, item) in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) != default:
            return _error(f"{flag} is not ported to voxtral_tpu_torch yet "
                          f"(ROADMAP {item})")
    audio_paths = args.audio
    if args.audio_list:
        if args.audio:
            return _error("--audio conflicts with --audio-list")
        list_path = Path(args.audio_list)
        if not list_path.exists():
            return _error(f"audio list not found: {list_path}")
        audio_paths = [line.strip()
                       for line in list_path.read_text().splitlines()
                       if line.strip()]
    if args.timestamps and args.batch_files > 0:
        return _error("--timestamps is per-file (drop --batch-files)")
    if args.gguf and not (args.tokenizer or args.random_weights):
        return _error("--gguf requires --tokenizer")

    if args.server:
        if not audio_paths:
            return _error("no audio files specified (--audio or --audio-list)")
        for flag, given in (("--gguf", args.gguf),
                            ("--random-weights", args.random_weights),
                            ("--batch-files", args.batch_files > 0),
                            ("--tp", args.tp > 1), ("--dp", args.dp > 1)):
            if given:
                return _error(f"{flag} conflicts with --server (decode "
                              "configuration lives on the serving host)")
        return _run_remote(args, audio_paths)

    try:
        device, mesh = device_and_mesh(args)
    except ArgError as exc:
        return _error(str(exc))
    if not (args.random_weights or args.gguf or args.model):
        return _error("no weights: pass --model DIR, --random-weights or "
                      "--gguf PATH")
    if not audio_paths:
        return _error("no audio files specified (--audio or --audio-list)")
    if args.max_mel_frames <= 0:
        return _error("--max-mel-frames must be greater than 0")
    if args.speculative < 0:
        return _error("--speculative must be >= 0")

    from voxtral_tpu_torch.pipeline import PipelineConfig

    pcfg = PipelineConfig(
        delay_tokens=args.delay, max_mel_frames=args.max_mel_frames,
        speculative=args.speculative, draft=args.draft_policy)
    try:
        pipeline = load_pipeline(args, pcfg, device, mesh)
    except ArgError as exc:
        return _error(str(exc))

    if args.batch_files > 0:
        present = [p for p in audio_paths if Path(p).exists()]
        for path in audio_paths:
            if path not in present:
                print(f"error: audio file not found: {path}", file=sys.stderr)
        try:
            texts = dict(zip(present, pipeline.transcribe_files_batched(
                present, batch_size=args.batch_files)))
        except Exception as exc:  # reported, as the JAX CLI does
            print(f"error: batched transcription failed: {exc}",
                  file=sys.stderr)
            return 1
        for path in audio_paths:
            print(texts.get(path, ""), flush=True)
        return 0 if len(present) == len(audio_paths) else 1

    status = 0
    for path in audio_paths:
        if not Path(path).exists():
            print(f"error: audio file not found: {path}", file=sys.stderr)
            print("")
            status = 1
            continue
        if args.timestamps:
            result = pipeline.transcribe_file_words(path)
            print(json.dumps({"file": str(path), **result}), flush=True)
        else:
            print(pipeline.transcribe_file(path), flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
