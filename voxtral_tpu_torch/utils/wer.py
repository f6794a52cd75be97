"""Word/character error rate with jiwer-style normalization (a copy of
``voxtral_tpu/utils/wer.py``).

Self-contained replacement for the reference harness's jiwer dependency
(``scripts/eval_wer.py`` of the reference): lowercase, strip punctuation,
collapse whitespace, then Levenshtein distance over words (WER) and
characters (CER).
"""

from __future__ import annotations

import unicodedata


def normalize_text(text: str) -> str:
    """jiwer-exact normalization for ASR scoring.

    Mirrors the reference harness's pipeline
    (the reference's ``scripts/eval_wer.py:93-96``)::

        RemoveMultipleSpaces()(Strip()(ToLowerCase()(RemovePunctuation()(text))))

    ``jiwer.RemovePunctuation`` deletes every Unicode punctuation character
    (category ``P*``) with NO space substitution — ``"don't" -> "dont"``,
    ``"end.Start" -> "endstart"``.  Matching this exactly keeps our WER
    numbers directly comparable to the reference's 8.49%/4.90% bars.
    """
    text = "".join(ch for ch in text if not unicodedata.category(ch).startswith("P"))
    text = text.lower()
    return " ".join(text.split())


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance with O(min(len)) memory."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i]
        for j, h in enumerate(hyp, 1):
            cur.append(min(
                prev[j] + 1,           # deletion
                cur[j - 1] + 1,        # insertion
                prev[j - 1] + (r != h),  # substitution
            ))
        prev = cur
    return prev[-1]


def wer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    if normalize:
        reference = normalize_text(reference)
        hypothesis = normalize_text(hypothesis)
    ref_words = reference.split()
    hyp_words = hypothesis.split()
    if not ref_words:
        return 0.0 if not hyp_words else 1.0
    return edit_distance(ref_words, hyp_words) / len(ref_words)


def cer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    if normalize:
        reference = normalize_text(reference)
        hypothesis = normalize_text(hypothesis)
    if not reference:
        return 0.0 if not hypothesis else 1.0
    return edit_distance(list(reference), list(hypothesis)) / len(reference)


def aggregate_wer(refs: list[str], hyps: list[str]) -> dict:
    """Corpus-level WER/CER (errors pooled over all utterances)."""
    assert len(refs) == len(hyps)
    word_errors = word_total = char_errors = char_total = 0
    per_utt = []
    for r, h in zip(refs, hyps):
        rn, hn = normalize_text(r), normalize_text(h)
        we = edit_distance(rn.split(), hn.split())
        ce = edit_distance(list(rn), list(hn))
        word_errors += we
        word_total += len(rn.split())
        char_errors += ce
        char_total += len(rn)
        per_utt.append({
            "wer": we / max(len(rn.split()), 1),
            "cer": ce / max(len(rn), 1),
        })
    return {
        "wer": word_errors / max(word_total, 1),
        "cer": char_errors / max(char_total, 1),
        "utterances": len(refs),
        "word_errors": word_errors,
        "words": word_total,
        "per_utterance": per_utt,
    }
