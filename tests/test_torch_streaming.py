"""The live session: the port's ``StreamingSession`` against the JAX one.

The same numpy weights and the same ragged pieces of audio go into
``voxtral_tpu.streaming.StreamingSession`` (its default generic route on
the CPU for w8 and q4; the stack kernel in interpret mode,
``VOXTRAL_MEGAKERNEL=force``, for q4g, whose generic route computes
with bf16 activations where the stack kernel quantizes them) and into
``voxtral_tpu_torch.streaming.StreamingSession`` (on the CPU: the plain
versions of its kernels, K1 in its ring mode (d) on unbounded sessions).
Bounded and unbounded: the tiny configurations' windows are short, so
both rings wrap and the permanent head leaves the decoder's window.

Greedy tokens must be identical.  Tiny random models have near-ties
that a one-ulp difference flips (ROADMAP §3), so the weights and audio
below were chosen with every top-2 logit margin of the port's session
above MIN_MARGIN; the tests assert the margin, so a flip can be told
from a fault.  Speculative sessions (port only: JAX's needs its stack
kernel) must give the sequential tokens for both draft policies.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
from voxtral_tpu.streaming import StreamingSession as JaxSession
from voxtral_tpu.tokenizer import VoxtralTokenizer as JaxTokenizer
from voxtral_tpu_torch.models.voxtral import PREFIX_LEN, VoxtralModel
from voxtral_tpu_torch.streaming import StreamingSession
from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

from tests.test_torch_gguf import gguf_cfg
from tests.test_torch_model import (
    FINAL_NORM_GAIN,
    SCALE,
    SEED,
    dense_params,
    tiny_config,
)
from tests.test_torch_pipeline import tekken_json

MIN_MARGIN = 0.1     # w8 (measured minimum 0.364)
Q4_MIN_MARGIN = 0.05  # q4g / q4 (measured 0.086 / 0.242)
SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The sessions run thousands of tiny ops: one intra-op thread runs
    them about 3x faster than the default pool, and it leaves the cores
    to the other test workers (whose own pools otherwise oversubscribe
    them several times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noise(secs: float = 10.0, seed: int = 3) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=int(secs * SR))
            * 0.25).astype(np.float32)


def ragged(sig: np.ndarray, seed: int = 1) -> list:
    """Pieces of 1000-9000 samples, and a few odd sizes."""
    rng = np.random.default_rng(seed)
    cuts = np.cumsum(np.concatenate([[1, 7, 2559],
                                     rng.integers(1000, 9000, size=80)]))
    return np.split(sig, cuts[cuts < len(sig)])


def run(session, pieces):
    for p in pieces:
        session.feed(p)
    session.finish()
    return session


@pytest.fixture(scope="module")
def w8():
    """(config, numpy w8 tree, JAX model, port model, pieces, tokenizers)."""
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    cfg = tiny_config()
    tree = quantize_params_w8(dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN))
    jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    assert jmodel.fused_decode is None  # the generic route
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    model.record_margins = True
    toks = (JaxTokenizer.from_json(tekken_json()),
            VoxtralTokenizer.from_json(tekken_json()))
    return cfg, tree, jmodel, model, ragged(noise()), toks


@pytest.fixture(scope="module")
def w8_runs(w8):
    """{unbounded: (JAX session, port session)} over the whole audio."""
    _, _, jmodel, model, pieces, (jtok, ttok) = w8
    out = {}
    for unbounded in (False, True):
        kw = dict(step_positions=8, max_duration_s=30, unbounded=unbounded)
        out[unbounded] = (run(JaxSession(jmodel, jtok, **kw), pieces),
                          run(StreamingSession(model, ttok, **kw), pieces))
    return out


def test_encoder_layers_with_cache_matches_jax():
    """The cached encoder stack over three uneven chunks (f32), bounded
    and head+ring, against JAX and (bounded) the full forward; 1e-5."""
    from voxtral_tpu.models import encoder as je
    from voxtral_tpu.models import layers as jl
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.models import encoder as te
    from voxtral_tpu_torch.models import layers as tl

    cfg = tiny_config().audio_encoder
    params = dense_params(tiny_config(), 2, 0.1)["encoder"]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    mel = np.random.default_rng(1).normal(size=(1, 128, 64)).astype(
        np.float32)
    feats = jnp.swapaxes(jl.conv_downsample(jnp.asarray(mel), jp["conv"]),
                         1, 2)
    tfeats = torch.from_numpy(np.array(feats))
    for ring, chunks in ((None, [(0, 6), (6, 7), (7, 16)]),
                         ((6, 4), [(0, 6), (6, 10), (10, 14), (14, 16)])):
        slots = 16 if ring is None else sum(ring)
        jc = je.create_encoder_cache(cfg, 1, slots, jnp.float32)
        tc = te.create_encoder_cache(cfg, 1, slots, torch.float32, "cpu")
        jrope = jl.rope_tables(cfg.head_dim, 16, cfg.rope_theta)
        trope = tl.rope_tables(cfg.head_dim, 16, cfg.rope_theta)
        jout, tout = [], []
        for lo, hi in chunks:
            o, jc = je.encoder_layers_with_cache(jp, feats[:, lo:hi], jc, cfg,
                                                 jrope, ring=ring)
            jout.append(np.asarray(o))
            o, tc = te.encoder_layers_with_cache(tp, tfeats[:, lo:hi], tc,
                                                 cfg, trope, ring=ring)
            tout.append(o.numpy())
        ref, got = np.concatenate(jout, 1), np.concatenate(tout, 1)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        assert tc.length == 16
        if ring is None:
            full = te.encoder_forward(tp, torch.from_numpy(mel), cfg)
            np.testing.assert_allclose(got, full.numpy(), rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
    # The chunk-incremental entry (conv per chunk, its edges not exact)
    # over two mel chunks, against JAX's.
    jc = je.create_encoder_cache(cfg, 1, 16, jnp.float32)
    tc = te.create_encoder_cache(cfg, 1, 16, torch.float32, "cpu")
    for lo, hi in ((0, 24), (24, 64)):
        ref, jc = je.encoder_forward_with_cache(
            jp, jnp.asarray(mel[:, :, lo:hi]), jc, cfg, jrope)
        got, tc = te.encoder_forward_with_cache(
            tp, torch.from_numpy(mel[:, :, lo:hi]), tc, cfg, trope)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(ref)).max())
    assert tc.length == 16


@pytest.mark.parametrize("unbounded", [False, True])
def test_w8_session_matches_jax(w8, w8_runs, unbounded):
    jses, ses = w8_runs[unbounded]
    assert ses.positions_done == jses.positions_done > PREFIX_LEN + 8
    assert len(ses.tokens) == ses.positions_done - PREFIX_LEN
    assert len(set(ses.tokens)) > 2  # not a constant stream
    margin = min(ses.margins)
    assert margin > MIN_MARGIN, f"near-tie: top-2 margin {margin:.4f}"
    assert ses.tokens == jses.tokens
    assert ses.text == jses.text and ses.words == jses.words
    if unbounded:
        assert ses._dec_ring == jses._dec_ring
        assert ses._enc_ring == jses._enc_ring
        # Both rings wrapped; the head left the decoder's window.
        assert ses.positions_done > ses._max_dec
        assert 4 * ses.positions_done > ses._max_enc
        lm = ses.cfg.language_model
        assert ses.positions_done > PREFIX_LEN + lm.sliding_window
    else:
        assert ses._max_dec == jses._max_dec


@pytest.mark.parametrize("draft", ["pad", "ngram"])
def test_w8_speculative_session_matches_sequential(w8, w8_runs, draft):
    _, _, _, model, pieces, _ = w8
    seq = w8_runs[True][1]
    spec = run(StreamingSession(model, step_positions=8, unbounded=True,
                                speculative=8, draft=draft), pieces)
    assert spec.tokens == seq.tokens
    m = spec.spec_metrics()
    steady = seq.positions_done - PREFIX_LEN - 8  # after the first step
    assert m["accepted_rows"] == steady
    assert 1 <= m["passes"] <= steady
    assert m["tokens_per_pass"] == round(steady / m["passes"], 3)
    if draft == "ngram":
        assert m["passes"] < steady


Q4_SEED, Q4_SCALE = 1, 0.05


def q4_cfg():
    """tests/test_torch_gguf.py's widths (K3's and q4g's gates) with
    short windows, so the decoder ring wraps within 10 s."""
    c = gguf_cfg()
    return dataclasses.replace(
        c, language_model=dataclasses.replace(c.language_model,
                                              sliding_window=40),
        audio_encoder=dataclasses.replace(c.audio_encoder,
                                          sliding_window=32))


@pytest.mark.parametrize("fmt", ["q4g", "q4"])
def test_q4_sessions_match_jax(fmt, monkeypatch):
    from voxtral_tpu_torch.utils.quantize import quantize_params_q4

    cfg = q4_cfg()
    tree = quantize_params_q4(
        dense_params(cfg, Q4_SEED, Q4_SCALE, FINAL_NORM_GAIN),
        pack=fmt == "q4")
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    assert model.decode_route == ("q4g" if fmt == "q4g" else "per_op")
    model.record_margins = True
    pieces = ragged(noise(), seed=2)
    ses = run(StreamingSession(model, unbounded=True), pieces)
    assert ses.positions_done > ses._max_dec  # the decoder ring wrapped
    margin = min(ses.margins)
    assert margin > Q4_MIN_MARGIN, f"near-tie: top-2 margin {margin:.4f}"
    monkeypatch.setenv("VOXTRAL_MEGAKERNEL",
                       "force" if fmt == "q4g" else "1")
    jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    assert (jmodel.fused_decode is not None) == (fmt == "q4g")
    jses = run(JaxSession(jmodel, unbounded=True), pieces)
    assert ses.tokens == jses.tokens
    if fmt == "q4g":
        spec = run(StreamingSession(model, unbounded=True, speculative=8),
                   pieces)
        assert spec.tokens == ses.tokens
    else:
        with pytest.raises(ValueError, match="fused K1 step"):
            StreamingSession(model, unbounded=True, speculative=8)


def test_port_checkpoint_continues(w8, w8_runs, tmp_path):
    """save mid-stream -> load -> the rest of the audio gives the
    uninterrupted session's tokens; the layout is JAX's."""
    _, _, _, model, pieces, (_, ttok) = w8
    whole = w8_runs[True][1]
    ses = StreamingSession(model, ttok, unbounded=True)
    half = len(pieces) // 2
    for p in pieces[:half]:
        ses.feed(p)
    assert ses.positions_done > PREFIX_LEN
    ses.save(tmp_path / "s.npz")
    back = StreamingSession.load(model, tmp_path / "s.npz", ttok)
    assert back.tokens == ses.tokens and back.text == ses.text
    run(back, pieces[half:])
    assert back.tokens == whole.tokens

    jstate = w8_runs[True][0].state_dict()
    state = whole.state_dict()
    assert set(state) == set(jstate)
    for k, v in jstate.items():
        if isinstance(v, np.ndarray):
            assert state[k].shape == v.shape, k


def test_jax_checkpoint_continues_in_port(w8, w8_runs, tmp_path):
    _, _, jmodel, model, pieces, _ = w8
    jses = JaxSession(jmodel, unbounded=True)
    half = len(pieces) // 3
    for p in pieces[:half]:
        jses.feed(p)
    assert jses.positions_done > PREFIX_LEN
    jses.save(tmp_path / "j.npz")
    ses = StreamingSession.load(model, tmp_path / "j.npz")
    assert ses.positions_done == jses.positions_done
    run(ses, pieces[half:])
    assert ses.tokens == w8_runs[True][0].tokens


def test_words_endpoint_utf8_and_finish(w8):
    """Host logic ported as it is: the UTF-8 hold-back, endpoints, feed
    after finish."""
    import base64
    import json

    _, _, _, model, _, (jtok, ttok) = w8
    e = "é".encode("utf-8")
    vocab = [{"rank": 1000 + i, "token_bytes": base64.b64encode(b).decode(),
              "is_control": False}
             for i, b in enumerate([b"caf", e[:1], e[1:]])]
    tok = VoxtralTokenizer.from_json(json.dumps({
        "config": {"default_vocab_size": 131072,
                   "default_num_special_tokens": 1000}, "vocab": vocab}))
    ses = StreamingSession(model, tok, max_duration_s=30)
    ses.tokens = [1000, 1001]  # "caf" + the first byte of "é"
    assert ses._emit() == "caf"
    ses.tokens = [1000, 1001, 1002]
    assert ses._emit() == "é" and ses.text == "café"

    ses = StreamingSession(model, ttok, max_duration_s=30)
    jses = JaxSession(w8[2], jtok, max_duration_s=30)
    for toks in ([32] * 9, [1005, 32, 32], [33, 1005, 1006] + [32] * 8,
                 [33, 1007] + [32] * 7):
        ses.tokens = jses.tokens = toks
        assert ses.endpoint() == jses.endpoint(), toks
        assert ses.words == jses.words
    ses.consume_endpoint()
    assert not ses.endpoint()
    ses.feed(np.zeros(1000, np.float32))
    ses.finish()
    with pytest.raises(RuntimeError, match="finished"):
        ses.feed(np.zeros(10, np.float32))
    assert ses.finish() == ""


def test_session_guards(w8):
    cfg, tree, _, model, _, _ = w8
    from voxtral_tpu_torch.streaming import StreamPool

    pool = StreamPool(model, max_streams=1, max_duration_s=30)
    with pytest.raises(ValueError, match="the pool's on a pooled session"):
        StreamingSession(model, pool=pool, speculative=4)
    with pytest.raises(ValueError, match="need an unbounded pool"):
        StreamingSession(model, pool=pool, unbounded=True)
    assert pool.free_slots == 1  # a refused session takes no slot
    with pytest.raises(ValueError, match="must be <= step_positions"):
        StreamingSession(model, step_positions=4, speculative=8)
    with pytest.raises(ValueError, match="draft policy"):
        StreamingSession(model, draft="oracle")
    wide = dataclasses.replace(cfg, language_model=dataclasses.replace(
        cfg.language_model, sliding_window=70000))
    big = VoxtralModel(model.params, wide, "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        StreamingSession(big, unbounded=True)  # before any allocation


def test_mel_windows_exact(w8):
    from voxtral_tpu_torch.audio.mel import MelSpectrogram

    ses = StreamingSession(w8[3], max_duration_s=30)
    ses._samples = np.concatenate([ses._samples, noise(6.0, 2)])
    full = MelSpectrogram.voxtral().compute_log(ses._samples)
    for lo, hi in [(0, 744), (740, 876)]:
        np.testing.assert_allclose(ses._mel_window(lo, hi)[0].T,
                                   full[lo:hi], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_session_kernels_match_plain_on_card(w8):
    """A tiny unbounded session through the kernels (K1 mode (d), K2) on
    the card against the same session through their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from voxtral_tpu_torch.ops import decode_step as k1

    _, tree, _, _, pieces, _ = w8
    cfg = w8[0]
    model = VoxtralModel.from_numpy(tree, cfg, "cuda")
    plain = VoxtralModel(model.params, cfg, "cuda", kernels=False)
    k1.decode_stack_step.launches = 0
    got = run(StreamingSession(model, unbounded=True), pieces)
    steady = got.positions_done - PREFIX_LEN - 8
    assert k1.decode_stack_step.launches == steady
    ref = run(StreamingSession(plain, unbounded=True), pieces)
    assert got.tokens == ref.tokens
    spec = run(StreamingSession(model, unbounded=True, speculative=8,
                                draft="ngram"), pieces)
    assert spec.tokens == got.tokens
