"""Pooled streaming, second part: the speculative pool, the guards, the
pump's error paths and the slot checkpoints (tests/test_torch_pool.py
holds the pools against JAX's tokens).

Speculative pools are held to the port's sequential pools of the same
cache type (exact greedy tokens whatever the draft; with int8 caches
because the spec step reads the fresh rows through the append's
quantization and keeps one requant group), and with pad drafts to JAX's
speculative pool: tokens, passes and accepted rows.  Checkpoints cross between
pools, solo sessions and the two packages and the stream goes on with
the same tokens.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voxtral_tpu.streaming import StreamingSession as JaxSession
from voxtral_tpu.streaming import StreamPool as JaxPool
import voxtral_tpu_torch.streaming as tstreaming
from voxtral_tpu_torch.models.voxtral import PREFIX_LEN
from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

from tests.test_torch_pool import (  # noqa: F401  (fixtures)
    A,
    B_,
    audio,
    one_torch_thread,
    scenario,
    solo,
    w8,
)


@pytest.fixture(scope="module")
def sequential(w8):
    """{(unbounded, kv_dtype): the sequential pool's tokens}."""
    model = w8[3]
    return {(u, kv): scenario(StreamingSession, StreamPool, model,
                              max_duration_s=30, unbounded=u,
                              kv_dtype=kv)[0]
            for u in (False, True) for kv in ("model", "int8")}


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("draft", ["pad", "ngram"])
@pytest.mark.parametrize("unbounded", [False, True])
def test_spec_pool_matches_sequential_pool(w8, sequential, unbounded, draft,
                                           kv_dtype):
    model = w8[3]
    got, pool, _ = scenario(StreamingSession, StreamPool, model,
                            max_duration_s=30, unbounded=unbounded,
                            kv_dtype=kv_dtype, speculative=8, draft=draft)
    assert pool.cache_int8 == (kv_dtype == "int8")
    assert got == sequential[unbounded, kv_dtype]
    m = pool.spec_metrics()
    assert set(m) == {"passes", "accepted_rows", "tokens_per_pass", "draft"}
    steady = sum(len(t) - 8 for t in got)  # after each stream's first step
    assert m["accepted_rows"] == steady and m["draft"] == draft
    assert 1 <= m["passes"] <= steady
    assert m["tokens_per_pass"] == round(steady / m["passes"], 3)
    if draft == "ngram":
        assert m["passes"] < steady // 2  # the shared table drafts well
    if not unbounded:
        assert pool.dec_k.shape[3] == pool.max_dec + 8 + 16  # the overshoot


@pytest.mark.parametrize("draft", ["pad", "ngram"])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_spec_pool_matches_jax_spec_pool(w8, sequential, kv_dtype, draft):
    """The pooled spec step beside JAX's on a bounded pool: the same
    tokens, and the same passes and accepted rows, which a wrong
    per-slot advance or live mask would move even where the tokens
    survive it.  The pad policy drafts the streams' most frequent token,
    so that passes accept several rows (with the true pad token none is
    accepted on these weights and passes == rows whatever the advance)."""
    _, _, jmodel, model = w8
    seq = sequential[False, kv_dtype]
    common = int(np.bincount(np.concatenate(seq)).argmax())
    kw = dict(max_duration_s=30, kv_dtype=kv_dtype, speculative=8,
              draft=draft, draft_token=common)
    ref, jpool, _ = scenario(JaxSession, JaxPool, jmodel, **kw)
    got, pool, _ = scenario(StreamingSession, StreamPool, model, **kw)
    assert pool.dec_k.shape == jpool.dec_k.shape
    assert pool.cache_int8 == jpool.cache_int8 == (kv_dtype == "int8")
    assert got == ref == seq
    m, jm = pool.spec_metrics(), jpool.spec_metrics()
    assert m == jm
    assert 0 < m["passes"] < m["accepted_rows"]  # several rows a pass


def test_spec_pool_matches_jax_shapes(w8):
    """The spec pool's geometry and counters are JAX's (its tokens are
    held to the sequential pool's above)."""
    _, _, jmodel, model = w8
    kw = dict(max_streams=2, max_duration_s=30, speculative=4, draft="ngram")
    jpool, pool = JaxPool(jmodel, **kw), StreamPool(model, **kw)
    assert pool.dec_k.shape == jpool.dec_k.shape
    assert pool._draft_table.shape == jpool._draft_table.shape
    assert pool.spec_metrics() == jpool.spec_metrics()
    assert StreamPool(model, max_streams=2).spec_metrics() is None


def test_pool_guards(w8):
    cfg, tree, _, model = w8
    with pytest.raises(ValueError, match="draft policy"):
        StreamPool(model, draft="oracle")
    with pytest.raises(ValueError, match="must be <= step_positions"):
        StreamPool(model, step_positions=4, speculative=8)
    with pytest.raises(ValueError, match="kv_dtype must be"):
        StreamPool(model, kv_dtype="bf16", speculative=4)
    pool = StreamPool(model, max_streams=1, max_duration_s=30)
    StreamingSession(model, pool=pool)
    with pytest.raises(RuntimeError, match="pool full"):
        StreamingSession(model, pool=pool)
    ses = StreamingSession(model, step_positions=4, delay_tokens=2.0,
                           pool=StreamPool(model, delay_tokens=3.0))
    # The pool's geometry and delay are the session's.
    assert (ses.P, ses._delay_tokens, ses.unbounded) == (8, 3.0, False)
    assert ses.spec_metrics() is None and not ses.overrun


def test_generic_pool_refuses_spec():
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.utils.quantize import quantize_params_q4

    from tests.test_torch_model import FINAL_NORM_GAIN, dense_params
    from tests.test_torch_streaming import Q4_SCALE, Q4_SEED, q4_cfg

    cfg = q4_cfg()
    tree = quantize_params_q4(
        dense_params(cfg, Q4_SEED, Q4_SCALE, FINAL_NORM_GAIN), pack=True)
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    with pytest.raises(ValueError, match="need the fused K1 step"):
        StreamPool(model, speculative=4)
    pool = StreamPool(model, max_streams=2, kv_dtype="int8")
    assert pool._fused is None and not pool.cache_int8  # the generic pool
    assert pool.dec_k.dtype == torch.bfloat16 and pool.dec_k.dim() == 6


def test_pump_keeps_tokens_when_a_step_raises(w8, monkeypatch):
    """Deferred token fetches flush on the error path too: the positions
    of the finished steps already advanced."""
    model = w8[3]
    pool = StreamPool(model, max_streams=2, max_duration_s=30)
    ses = StreamingSession(model, pool=pool)
    step, calls = pool._pool_step_fused, []

    def flaky(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("a fault in the third step")
        return step(*a)

    monkeypatch.setattr(pool, "_pool_step_fused", flaky)
    with pytest.raises(RuntimeError, match="third step"):
        ses.feed(A)
    assert ses.positions_done == PREFIX_LEN + 8 + 2 * 8
    assert len(ses.tokens) == ses.positions_done - PREFIX_LEN
    whole = StreamingSession(model, max_duration_s=30)
    whole.feed(A)
    assert ses.tokens == whole.tokens[:len(ses.tokens)]


def test_overrun_marks_and_does_not_stall_the_others(w8, solo):
    """A stream that outruns a bounded pool's caches is marked, not
    raised; the other slot goes on to its end."""
    model = w8[3]
    pool = StreamPool(model, max_streams=2, max_duration_s=5)
    long, short = (StreamingSession(model, pool=pool) for _ in range(2))
    long.feed(A, pump=False)
    short.feed(B_, pump=False)
    pool.pump()
    assert long.overrun and not short.overrun
    assert long.positions_done + 8 > pool.max_dec >= long.positions_done
    assert len(long.tokens) == long.positions_done - PREFIX_LEN
    short.finish()
    assert short.tokens == solo[False][1]
    assert long.tokens == solo[False][0][:len(long.tokens)]


# -- checkpoints ----------------------------------------------------------------


def split_run(make_first, make_second, cut=3, sig=A):
    """One stream of ``sig`` (the scenario's signal A): ``make_first()``
    runs the first ``cut`` fifths, its state goes through
    ``make_second(state)``, which runs the rest.  -> (tokens, state)."""
    pieces = np.array_split(sig, 5)
    first = make_first()
    for p in pieces[:cut]:
        first.feed(p)
    assert first.positions_done > PREFIX_LEN + 8
    state = first.state_dict()
    second = make_second(state)
    assert second.tokens == first.tokens
    for p in pieces[cut:]:
        second.feed(p)
    second.finish()
    return second.tokens, state


@pytest.mark.parametrize("unbounded", [False, True])
def test_int8_pool_checkpoint_requantizes_exactly(w8, unbounded):
    """int8 pool -> slot_state -> another int8 pool: codes and scales
    come back bit for bit, and the stream goes on with the tokens of the
    uninterrupted pool."""
    model = w8[3]
    kw = dict(max_streams=2, max_duration_s=30, unbounded=unbounded,
              kv_dtype="int8")
    whole = StreamingSession(model, pool=StreamPool(model, **kw))
    for p in np.array_split(A, 5):
        whole.feed(p)
    whole.finish()
    src, dst = StreamPool(model, **kw), StreamPool(model, **kw)
    StreamingSession(model, pool=dst)  # the restored one takes slot 1
    tokens, state = split_run(
        lambda: StreamingSession(model, pool=src),
        lambda st: StreamingSession.restore(model, st, pool=dst))
    assert tokens == whole.tokens
    assert state["dec_k"].shape[2] == src._solo_geometry()[0]
    # Slot 0 of src against slot 1 of dst, at the checkpoint's positions.
    src2 = StreamPool(model, **kw)
    s2 = StreamingSession.restore(model, state, pool=src2)
    n = min(int(state["dec_len"]), src.dec_k.shape[3])
    for name in ("dec_k", "dec_v", "dec_ks", "dec_vs"):
        a, b = getattr(src, name), getattr(src2, name)
        assert torch.equal(a[:, 0, :, :n], b[:, s2._slot, :, :n]), name


@pytest.mark.parametrize("unbounded", [False, True])
def test_pool_to_solo_to_pool(w8, solo, unbounded, tmp_path):
    """bf16 pool -> solo session (through save / load) -> another pool:
    the solo session's tokens throughout."""
    model = w8[3]
    kw = dict(max_streams=2, max_duration_s=30, unbounded=unbounded,
              kv_dtype="model")
    pieces = np.array_split(A, 5)
    ses = StreamingSession(model, pool=StreamPool(model, **kw))
    for p in pieces[:2]:
        ses.feed(p)
    ses.save(tmp_path / "pooled.npz")
    mid = StreamingSession.load(model, tmp_path / "pooled.npz")
    assert mid._pool is None and mid.unbounded == unbounded
    mid.feed(pieces[2])
    mid.save(tmp_path / "solo.npz")
    last = StreamingSession.load(model, tmp_path / "solo.npz",
                                 pool=StreamPool(model, **kw))
    assert last._pool is not None
    for p in pieces[3:]:
        last.feed(p)
    last.finish()
    assert last.tokens == solo[unbounded][0]


def test_chunked_pool_checkpoint_remaps_the_ring(w8, monkeypatch):
    """A chunk-grown ring comes out in the solo ring's layout
    (``_ring_remap``) and goes back in; the stream goes on as the
    uninterrupted chunked pool's."""
    model = w8[3]
    orig = tstreaming._fused_plan
    monkeypatch.setattr(
        tstreaming, "_fused_plan",
        lambda m, batch, cache_s, itemsize=None, chunk=None, **kw: None
        if chunk is None else orig(m, batch, cache_s, itemsize=itemsize,
                                   chunk=chunk, **kw))
    monkeypatch.setattr(tstreaming, "CACHE_CHUNK", 64)
    kw = dict(max_streams=2, unbounded=True, kv_dtype="model")
    whole = StreamingSession(model, pool=StreamPool(model, **kw))
    assert whole._pool._cache_chunk == 64
    assert whole._pool._dec_ring == (PREFIX_LEN, 128 - PREFIX_LEN)
    long = audio(20, 3)  # past the grown ring's wrap at 128 positions
    for p in np.array_split(long, 5):
        whole.feed(p)
    whole.finish()
    tokens, state = split_run(
        lambda: StreamingSession(model, pool=StreamPool(model, **kw)),
        lambda st: StreamingSession.restore(model, st,
                                            pool=StreamPool(model, **kw)),
        cut=4, sig=long)
    lm = model.config.language_model
    assert state["dec_k"].shape[2] == PREFIX_LEN + lm.sliding_window + 8
    assert int(state["positions_done"]) > 128  # the grown ring had wrapped
    assert tokens == whole.tokens


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_checkpoints_cross_the_packages(w8, kv_dtype):
    """A JAX pool's slot_state restores into a port pool, and a port
    pool's into a JAX pool and a JAX solo session; the stream goes on
    with the uninterrupted JAX pool's tokens."""
    _, _, jmodel, model = w8
    kw = dict(max_streams=2, unbounded=True, kv_dtype=kv_dtype)
    whole = JaxSession(jmodel, pool=JaxPool(jmodel, **kw))
    for p in np.array_split(A, 5):
        whole.feed(p)
    whole.finish()
    tokens, jstate = split_run(
        lambda: JaxSession(jmodel, pool=JaxPool(jmodel, **kw)),
        lambda st: StreamingSession.restore(model, st,
                                            pool=StreamPool(model, **kw)))
    assert tokens == whole.tokens
    tokens, state = split_run(
        lambda: StreamingSession(model, pool=StreamPool(model, **kw)),
        lambda st: JaxSession.restore(jmodel, st, pool=JaxPool(jmodel, **kw)))
    assert tokens == whole.tokens
    assert set(state) == set(jstate)
    for k, v in jstate.items():
        if isinstance(v, np.ndarray):
            assert np.asarray(state[k]).shape == v.shape, k
    if kv_dtype == "model":
        tokens, _ = split_run(
            lambda: StreamingSession(model, pool=StreamPool(model, **kw)),
            lambda st: JaxSession.restore(jmodel, st))
        assert tokens == whole.tokens


def test_restore_into_a_pool_checks_the_geometry(w8):
    model = w8[3]
    ses = StreamingSession(model, pool=StreamPool(model, max_duration_s=30))
    ses.feed(A[:70000])
    state = ses.state_dict()
    with pytest.raises(ValueError, match="pool geometry mismatch"):
        StreamingSession.restore(model, state,
                                 pool=StreamPool(model, unbounded=True))
    with pytest.raises(ValueError, match="pool geometry mismatch"):
        StreamingSession.restore(
            model, state, pool=StreamPool(model, step_positions=4,
                                          max_duration_s=30))
    with pytest.raises(ValueError, match="cache geometry mismatch"):
        StreamingSession.restore(model, state,
                                 pool=StreamPool(model, max_duration_s=60))
    with pytest.raises(ValueError, match="delay_tokens mismatch"):
        StreamingSession.restore(
            model, state, pool=StreamPool(model, max_duration_s=30,
                                          delay_tokens=4.0))
    with pytest.raises(ValueError, match="unsupported checkpoint version"):
        StreamingSession.restore(model, dict(state, version=2),
                                 pool=StreamPool(model, max_duration_s=30))
