"""Tekken tokenizer (decode-only) for Voxtral.

Behavioral contract mirrors the reference
(``voxtral-mini-realtime-rs/src/tokenizer/mod.rs``):

* ``tekken.json`` holds a ``config`` block and a ``vocab`` list whose
  entries carry base64 ``token_bytes`` (text tokens) or ``token_str`` with
  ``is_control: true`` (special tokens).
* Text token ID = vocab index + 1000.  IDs 0-999 are special/control tokens
  (BOS=1, ``[STREAMING_PAD]``=32, ``[STREAMING_WORD]``=33) and are skipped by
  :meth:`VoxtralTokenizer.decode`.
* Accumulated bytes are decoded as UTF-8 with invalid sequences replaced.

The port's own copy of ``voxtral_tpu/tokenizer.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Iterable, Optional

TEXT_TOKEN_OFFSET = 1000

BOS_TOKEN = 1
STREAMING_PAD = 32
STREAMING_WORD = 33

# One decoder position = 2560 samples = 160 ms of audio (two
# mistral-common 80 ms audio tokens; pad.rs:54-57, config.rs:393-401).
SECONDS_PER_POSITION = 0.16


class VoxtralTokenizer:
    """Decode-only Tekken tokenizer (vocab 131072)."""

    def __init__(
        self,
        vocab_bytes: list[Optional[bytes]],
        special_tokens: dict[int, str],
        vocab_size: int,
    ):
        self._vocab_bytes = vocab_bytes
        self._special_tokens = special_tokens
        self._vocab_size = vocab_size

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_json(cls, text: str) -> "VoxtralTokenizer":
        try:
            tekken = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"tekken.json is not valid JSON: {e}") from e
        if not isinstance(tekken, dict) or "vocab" not in tekken:
            raise ValueError(
                "tekken.json malformed: expected an object with 'vocab' "
                "and 'config' keys")
        try:
            vocab_size = int(tekken["config"]["default_vocab_size"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(
                "tekken.json malformed: missing "
                f"config.default_vocab_size ({e})") from e
        vocab = tekken["vocab"]
        if not isinstance(vocab, list) or not all(
                isinstance(v, dict) for v in vocab):
            raise ValueError(
                "tekken.json malformed: 'vocab' must be a list of objects")

        vocab_bytes: list[Optional[bytes]] = [None] * len(vocab)
        special_tokens: dict[int, str] = {}

        for idx, entry in enumerate(vocab):
            if entry.get("is_control", False):
                s = entry.get("token_str")
                if s is not None:
                    # Special tokens use their rank directly as the token ID.
                    special_tokens[int(entry["rank"])] = s
                continue

            b64 = entry.get("token_bytes")
            if b64 is not None:
                try:
                    vocab_bytes[idx] = base64.b64decode(b64)
                    continue
                except Exception:
                    pass

            s = entry.get("token_str")
            if s is not None:
                vocab_bytes[idx] = s.encode("utf-8")

        return cls(vocab_bytes, special_tokens, vocab_size)

    @classmethod
    def from_file(cls, path: str | Path) -> "VoxtralTokenizer":
        return cls.from_json(Path(path).read_text())

    @classmethod
    def from_model_dir(cls, dirpath: str | Path) -> "VoxtralTokenizer":
        return cls.from_file(Path(dirpath) / "tekken.json")

    # -- decoding -----------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        """Decode token IDs to text, skipping control tokens (< 1000)."""
        out = bytearray()
        n = len(self._vocab_bytes)
        for tid in ids:
            tid = int(tid)
            if tid < TEXT_TOKEN_OFFSET:
                continue
            vocab_idx = tid - TEXT_TOKEN_OFFSET
            if vocab_idx < n:
                b = self._vocab_bytes[vocab_idx]
                if b is not None:
                    out += b
        return out.decode("utf-8", errors="replace")

    def decode_words(
        self,
        ids: Iterable[int],
        delay_s: float = 0.0,
        offset_s: float = 0.0,
    ) -> list[dict]:
        """Word-level timestamps from the streaming control tokens.

        The model emits ``[STREAMING_WORD]`` (33) at the decoder position
        where a word STARTS, the word's text tokens (>= 1000) right
        after, and ``[STREAMING_PAD]`` (32) through silence
        (reference semantics: docs/VOXTRAL_ARCHITECTURE.md:524,
        voxtral.rs:292).  Token index ``i`` covers audio span
        ``[i*0.16, (i+1)*0.16)`` (one decoder position = 160 ms), and
        the model transcribes with a ``delay_s`` lookback (delay tokens
        x 80 ms), so a word's start is its marker's span start and its
        end is the closing token's span start, both shifted by
        ``offset_s - delay_s`` and clamped at 0.

        Returns ``[{"word", "start", "end"}, ...]`` with times in
        seconds relative to the original (unpadded) audio;
        ``offset_s`` shifts chunked files to absolute positions.
        Beyond reference parity — the reference discards the control
        tokens (tokenizer/mod.rs:170-191).
        """
        ids = [int(t) for t in ids]
        words: list[dict] = []
        cur: Optional[tuple[bytearray, float]] = None

        def t(i: int) -> float:
            return round(
                max(0.0, offset_s + i * SECONDS_PER_POSITION - delay_s), 3)

        def close(i: int) -> None:
            nonlocal cur
            if cur is not None and cur[0]:
                word = bytes(cur[0]).decode("utf-8",
                                            errors="replace").strip()
                if word:
                    words.append(
                        {"word": word, "start": cur[1], "end": t(i)})
            cur = None

        for i, tid in enumerate(ids):
            if tid == STREAMING_WORD:
                close(i)
                cur = (bytearray(), t(i))
            elif tid >= TEXT_TOKEN_OFFSET:
                if cur is None:  # text without a word marker: start one
                    cur = (bytearray(), t(i))
                vocab_idx = tid - TEXT_TOKEN_OFFSET
                if vocab_idx < len(self._vocab_bytes):
                    b = self._vocab_bytes[vocab_idx]
                    if b is not None:
                        cur[0].extend(b)
            else:  # any other control token ends the current word
                close(i)
        close(len(ids))
        return words

    def decode_token(self, tid: int) -> Optional[str]:
        """Decode one token ID; special tokens return their string name."""
        tid = int(tid)
        if tid < TEXT_TOKEN_OFFSET:
            return self._special_tokens.get(tid)
        vocab_idx = tid - TEXT_TOKEN_OFFSET
        if vocab_idx < len(self._vocab_bytes):
            b = self._vocab_bytes[vocab_idx]
            if b is not None:
                return b.decode("utf-8", errors="replace")
        return None

    @property
    def vocab_size(self) -> int:
        return self._vocab_size
