"""Pooled streaming: the port's ``StreamPool`` against the JAX one.

The same numpy weights and the same audio go into
``voxtral_tpu.streaming.StreamPool`` (its stack kernel in interpret mode,
``VOXTRAL_MEGAKERNEL=force``, as its own tests run it; the generic route
for packed q4) and into ``voxtral_tpu_torch.streaming.StreamPool`` (on
the CPU: the plain versions of its kernels, K1 with per-row offsets and
ring phases, int8 KV (mode (e)) and the chunked cache (mode (f))).

One scenario drives every pool: two slots, three sessions of 10 / 4 /
4 s fed in uneven pieces, the second attached after the first has
started, the first idle for a step, the second finished and detached
and the third attached to its slot mid-run; the long stream passes both
rings' wraps.  Greedy tokens must be identical, slot by slot.  The
weights are tests/test_torch_streaming.py's, chosen with every top-2
logit margin of the bf16-cache sessions above MIN_MARGIN (asserted on
the port's solo sessions, so a flip can be told from a fault); the int8
caches move the logits by about 1e-2 of their largest value on both
sides alike.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import voxtral_tpu.streaming as jstreaming
from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
from voxtral_tpu.streaming import StreamingSession as JaxSession
from voxtral_tpu.streaming import StreamPool as JaxPool
import voxtral_tpu_torch.streaming as tstreaming
from voxtral_tpu_torch.models.voxtral import PREFIX_LEN, VoxtralModel
from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

from tests.test_torch_model import (
    FINAL_NORM_GAIN,
    SCALE,
    SEED,
    dense_params,
    tiny_config,
)
from tests.test_torch_streaming import (
    MIN_MARGIN,
    Q4_MIN_MARGIN,
    Q4_SCALE,
    Q4_SEED,
    q4_cfg,
)

SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one intra-op thread runs them faster and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def audio(secs: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=int(secs * SR))
            * 0.25).astype(np.float32)


A, B_, C = audio(10, 3), audio(4, 5), audio(4, 7)
SIGNALS = (A, B_, C)
# The tiny q4 models sit on long near-ties for much 4 s noise (their
# margin on B_ is 0.027, and JAX's own solo session and pool disagree on
# about one seed in five): these two were picked with margins above 0.2
# and JAX's solo session, its pool and the port's session agreeing.
Q4_SIGNALS = (A, audio(4, 39), audio(4, 52))
# Packed q4 runs K3, whose f32 sums within each group of 32 k put the
# port's solo session on seed 39 at a top-2 margin of 0.036, under
# Q4_MIN_MARGIN (seed 42: 0.254, 52: 0.284): its solo comparison takes
# seed 42, and on seed 39 its pool is held to JAX's pool alone.
Q4_PACKED_SIGNALS = (A, audio(4, 42), audio(4, 52))


def scenario(Session, Pool, model, signals=SIGNALS, **pool_kw):
    """-> ([tokens of a, b, c], pool, the sessions)."""
    A, B_, C = signals
    pool = Pool(model, max_streams=2, step_positions=8, **pool_kw)
    pa, pb = np.array_split(A, 5), np.array_split(B_, 2)
    a = Session(model, pool=pool)
    a.feed(pa[0][:7])
    a.feed(pa[0][7:])
    a.feed(pa[1])                      # a runs alone, slot 1 is empty
    b = Session(model, pool=pool)
    b.feed(pb[0], pump=False)
    a.feed(pa[2])                      # b's init, then both step
    b.feed(pb[1])                      # a is idle for these steps
    b.finish()                         # detaches slot 1
    c = Session(model, pool=pool)      # a fresh session in b's slot
    assert c._slot == 1 and pool.free_slots == 0
    c.feed(C[:30000], pump=False)
    a.feed(pa[3])
    c.feed(C[30000:])
    a.feed(pa[4])
    a.finish()
    c.finish()
    assert pool.free_slots == 2
    return [a.tokens, b.tokens, c.tokens], pool, (a, b, c)


def solo_tokens(model, margin=None, signals=SIGNALS, **kw):
    out = []
    for sig in signals:
        s = StreamingSession(model, **kw)
        s.feed(sig)
        s.finish()
        if margin is not None:
            assert min(s.margins) > margin, f"near-tie: {min(s.margins):.4f}"
        out.append(s.tokens)
    return out


@pytest.fixture(scope="module")
def w8():
    """(config, numpy tree, JAX model on its stack kernel, port model)."""
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    cfg = tiny_config()
    tree = quantize_params_w8(dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN))
    mp = pytest.MonkeyPatch()
    mp.setenv("VOXTRAL_MEGAKERNEL", "force")
    try:
        jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    finally:
        mp.undo()
    assert jmodel.fused_decode is not None and jmodel._mk_interpret
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    model.record_margins = True
    return cfg, tree, jmodel, model


@pytest.fixture(scope="module")
def solo(w8):
    """{unbounded: the port's solo sessions' tokens} (margins checked)."""
    model = w8[3]
    return {u: solo_tokens(model, MIN_MARGIN, max_duration_s=30, unbounded=u)
            for u in (False, True)}


# -- the pieces ---------------------------------------------------------------


def test_append_scales_matches_jax():
    from voxtral_tpu_torch.models.voxtral import append_rows, append_scales

    rng = np.random.default_rng(0)
    arr = rng.normal(size=(3, 4, 2, 9)).astype(np.float32)
    new = rng.normal(size=(3, 4, 2)).astype(np.float32)
    offs = np.array([0, 8, 3, 3], np.int32)
    ref = jstreaming._append_scales(jnp.asarray(arr), jnp.asarray(new),
                                    jnp.asarray(offs))
    got = append_scales(torch.from_numpy(arr.copy()), torch.from_numpy(new),
                        torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # Beside int8 codes: append_rows on an int8 cache, rows given.
    codes = rng.integers(-127, 128, size=(3, 2, 2, 9, 4)).astype(np.int8)
    fresh = rng.integers(-127, 128, size=(3, 4, 2, 4)).astype(np.int8)
    rows = np.array([0, 0, 1, 1])
    slots = np.array([2, 3, 7, 8])
    want = codes.copy()
    for i in range(4):
        want[:, rows[i], :, slots[i]] = fresh[:, i]
    got = append_rows(torch.from_numpy(codes.copy()), torch.from_numpy(fresh),
                      torch.from_numpy(slots), torch.from_numpy(rows))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    sc = append_scales(torch.zeros((3, 2, 2, 9)), torch.from_numpy(new),
                       torch.from_numpy(slots), torch.from_numpy(rows))
    assert float(sc[1, 1, 0, 7]) == new[1, 2, 0]


@pytest.mark.parametrize("src,dst,written", [(13, 20, 10), (13, 20, 40),
                                             (20, 13, 40), (13, 13, 5)])
def test_ring_remap_matches_jax(src, dst, written):
    head = 3
    a = np.random.default_rng(1).normal(
        size=(2, 1, head + src, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tstreaming._ring_remap(a, head, src, dst, written),
        jstreaming._ring_remap(a, head, src, dst, written))


def test_batched_encoder_step_matches_batch1_and_jax():
    """The pooled encode half: B = 3 slots at their own cache lengths,
    one past the ring's wrap, in one batched pass (per-row RoPE, band
    mask and write slots), against three batch-1 calls of the solo
    function and against JAX's vmapped ``_encode_window``.  f32 weights:
    1e-5 of the largest value (summation order); the batch-1 calls agree
    to 1e-6 (the same ops on other batch shapes)."""
    from voxtral_tpu.models.layers import rope_tables as jrope_tables
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.models.layers import KVCache, rope_tables

    cfg = tiny_config()
    enc = cfg.audio_encoder
    P, ring = 8, (4 * PREFIX_LEN, 64)
    S = sum(ring)
    lens = [184, 216, 344]  # 4 x (46, 54, 86): the last is past the wrap
    params = dense_params(cfg, 2, 0.1)
    rng = np.random.default_rng(5)
    mel = rng.normal(size=(3, 128, 16 * P + 8)).astype(np.float32)
    ck = rng.normal(size=(enc.n_layers, 3, S, enc.n_kv_heads,
                          enc.head_dim)).astype(np.float32) * 0.3
    cv = rng.normal(size=ck.shape).astype(np.float32) * 0.3
    tp = params_from_numpy(params, "cpu")
    model = types.SimpleNamespace(params=tp, config=cfg, _mm=None,
                                  _cast_mel=torch.as_tensor)
    rope = rope_tables(enc.head_dim, 4 * 200, enc.rope_theta)

    def port(rows, lengths):
        k = torch.from_numpy(ck[:, rows].copy())
        v = torch.from_numpy(cv[:, rows].copy())
        x = tstreaming._conv(model, mel[rows])[:, 1:1 + 4 * P]
        out, _ = tstreaming._encode(model, x, KVCache(k, v, lengths), rope,
                                    ring)
        return out.numpy(), k.numpy(), v.numpy()

    got, gk, gv = port([0, 1, 2], torch.tensor(lens, dtype=torch.int32))
    for b in range(3):
        one, k1_, v1 = port([b], lens[b])
        for g, o in ((got[b:b + 1], one), (gk[:, b:b + 1], k1_),
                     (gv[:, b:b + 1], v1)):
            np.testing.assert_allclose(g, o, rtol=0,
                                       atol=1e-6 * np.abs(o).max())

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jrope = jrope_tables(enc.head_dim, 4 * 200, enc.rope_theta)

    def enc_one(mel_win, ek, ev, el):
        cache = jstreaming.KVCache(ek, ev, el)
        a, cache = jstreaming._encode_window(jp, mel_win, cache, cfg, jrope,
                                             4 * P, 0, ring)
        return a[0], cache.k, cache.v

    # JAX's slot layout [B, L, 1, S, H, hd].
    jk = jnp.asarray(ck.transpose(1, 0, 2, 3, 4)[:, :, None])
    jv = jnp.asarray(cv.transpose(1, 0, 2, 3, 4)[:, :, None])
    ref, rk, rv = jax.vmap(enc_one)(jnp.asarray(mel[:, None]), jk, jv,
                                    jnp.asarray(lens, jnp.int32))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    for g, r in ((gk, rk), (gv, rv)):
        r = np.asarray(r)[:, :, 0].transpose(1, 0, 2, 3, 4)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())


# -- pools against JAX ----------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("unbounded", [False, True])
def test_fused_pool_matches_jax(w8, solo, unbounded, kv_dtype):
    _, _, jmodel, model = w8
    kw = dict(max_duration_s=30, unbounded=unbounded, kv_dtype=kv_dtype)
    ref, jpool, _ = scenario(JaxSession, JaxPool, jmodel, **kw)
    got, pool, (a, _, _) = scenario(StreamingSession, StreamPool, model, **kw)
    assert jpool._fused is not None and pool._fused is not None
    assert pool.cache_int8 == jpool.cache_int8 == (kv_dtype == "int8")
    assert pool._cache_chunk is None and jpool._cache_chunk is None
    assert pool.dec_k.shape == jpool.dec_k.shape
    assert pool._dec_ring == jpool._dec_ring
    assert pool._enc_ring == jpool._enc_ring
    assert got == ref
    assert len(got[0]) == a.positions_done - PREFIX_LEN
    if unbounded:
        assert a.positions_done > 78  # past both rings' wraps
    if kv_dtype == "model":
        assert got == solo[unbounded]  # the pool == the port's solo session


@pytest.mark.parametrize("unbounded", [False, True])
def test_chunked_pool_matches_jax(w8, monkeypatch, unbounded):
    """The chunked rung (mode (f), int8), forced in both packages by
    replacing ``_fused_plan``, with chunks of 64 slots so a step walks
    several."""
    _, _, jmodel, model = w8

    def chunk_only(orig):
        def plan(model, batch, cache_s, itemsize=None, chunk=None, **kw):
            if chunk is None and batch > 1:
                return None
            return orig(model, batch, cache_s, itemsize=itemsize,
                        chunk=chunk, **kw)
        return plan

    for mod in (jstreaming, tstreaming):
        monkeypatch.setattr(mod, "_fused_plan", chunk_only(mod._fused_plan))
        monkeypatch.setattr(mod, "CACHE_CHUNK", 64)
    kw = dict(max_duration_s=30, unbounded=unbounded)
    ref, jpool, _ = scenario(JaxSession, JaxPool, jmodel, **kw)
    got, pool, _ = scenario(StreamingSession, StreamPool, model, **kw)
    assert pool._cache_chunk == jpool._cache_chunk == 64
    assert pool.cache_int8 and jpool.cache_int8  # "auto" went to int8
    assert pool.dec_k.shape == jpool.dec_k.shape
    assert pool.dec_k.shape[3] % 64 == 0
    assert pool._dec_ring == jpool._dec_ring  # grown to the padded S
    assert got == ref


@pytest.fixture(scope="module")
def q4_models():
    """{fmt: (JAX model, port model)} on tests/test_torch_streaming.py's
    q4 configuration: "q4g" fuses (mode (h)), "q4" is the per-op route."""
    from voxtral_tpu_torch.utils.quantize import quantize_params_q4

    cfg = q4_cfg()
    out = {}
    for fmt in ("q4g", "q4"):
        tree = quantize_params_q4(
            dense_params(cfg, Q4_SEED, Q4_SCALE, FINAL_NORM_GAIN),
            pack=fmt == "q4")
        mp = pytest.MonkeyPatch()
        mp.setenv("VOXTRAL_MEGAKERNEL", "force" if fmt == "q4g" else "1")
        try:
            jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
        finally:
            mp.undo()
        out[fmt] = (jmodel, VoxtralModel.from_numpy(tree, cfg, "cpu"))
    return out


@pytest.mark.parametrize("fmt", ["q4g", "q4"])
def test_q4_pools_match_jax(q4_models, fmt):
    """q4g: the fused pool on g32 weights.  Packed q4: the generic pool,
    each ready slot through the per-op step (K3's linears), so it equals
    the port's solo session too.  (A q4g pool's adapter sees B x P = 16
    rows and takes the q4 dispatch's many-row route, where the solo
    session's 8 rows take the blocked one: the pool is held to JAX's
    pool, not to the solo session.)"""
    jmodel, model = q4_models[fmt]
    assert (model.fused_decode is not None) == (fmt == "q4g")
    model.record_margins = True
    kw = dict(unbounded=True,
              signals=Q4_SIGNALS if fmt == "q4g" else Q4_PACKED_SIGNALS)
    solo = solo_tokens(model, Q4_MIN_MARGIN, **kw)
    ref, jpool, _ = scenario(JaxSession, JaxPool, jmodel, **kw)
    got, pool, _ = scenario(StreamingSession, StreamPool, model, **kw)
    assert (pool._fused is not None) == (jpool._fused is not None) \
        == (fmt == "q4g")
    assert got == ref
    if fmt == "q4":
        assert got == solo


def test_q4_packed_pool_matches_jax_on_a_near_tie(q4_models):
    """Packed q4 on Q4_SIGNALS, whose seed-39 signal the port's solo
    session decodes at a top-2 margin of 0.036 under K3's summation
    order: the pool's tokens still equal JAX's pool's.  (No solo
    comparison: that margin is under the near-tie guard.)"""
    jmodel, model = q4_models["q4"]
    kw = dict(unbounded=True, signals=Q4_SIGNALS)
    ref, _, _ = scenario(JaxSession, JaxPool, jmodel, **kw)
    got, _, _ = scenario(StreamingSession, StreamPool, model, **kw)
    assert got == ref


# -- the ladder -----------------------------------------------------------------


def test_kv_dtype_ladder(w8, monkeypatch):
    """"auto" asks _fused_plan rung by rung, in order; the first admitted
    rung sets the caches; an unknown kv_dtype and a pool no rung admits
    raise."""
    model = w8[3]
    asked = []
    orig = tstreaming._fused_plan

    def refuse(n):
        def plan(model, batch, cache_s, itemsize=None, chunk=None, **kw):
            asked.append((itemsize, chunk, cache_s))
            if len(asked) <= n:
                return None
            return orig(model, batch, cache_s, itemsize=itemsize,
                        chunk=chunk, **kw)
        return plan

    s_dec = int(30 * 6.25) + PREFIX_LEN + 16 + 8
    for n, (int8, chunk) in enumerate([(False, None), (True, None),
                                       (True, 512)]):
        asked.clear()
        monkeypatch.setattr(tstreaming, "_fused_plan", refuse(n))
        pool = StreamPool(model, max_streams=2, max_duration_s=30)
        padded = -(-s_dec // 512) * 512
        assert asked == [(None, None, s_dec), (1, None, s_dec),
                         (1, 512, padded)][:n + 1]
        assert (pool.cache_int8, pool._cache_chunk) == (int8, chunk)
        assert pool.dec_k.shape[3] == (padded if chunk else s_dec)
        assert pool.dec_k.dtype == (torch.int8 if int8 else torch.bfloat16)
        assert (pool.dec_ks is not None) == int8
    asked.clear()
    monkeypatch.setattr(tstreaming, "_fused_plan", refuse(9))
    with pytest.raises(ValueError, match="K1 can take no rung") as e:
        StreamPool(model, max_streams=2, max_duration_s=30, kv_dtype="model")
    assert [a[:2] for a in asked] == [(None, None), (None, 512)]
    assert "refused by _fused_plan" in str(e.value)
    monkeypatch.setattr(tstreaming, "_fused_plan", orig)
    with pytest.raises(ValueError, match="kv_dtype must be"):
        StreamPool(model, kv_dtype="fp8")
    # Spec pools ride the resident rungs only.
    asked.clear()
    monkeypatch.setattr(tstreaming, "_fused_plan", refuse(9))
    with pytest.raises(ValueError, match="K1 can take no rung"):
        StreamPool(model, max_streams=2, max_duration_s=30, speculative=4)
    assert [a[:2] for a in asked] == [(None, None), (1, None)]


def test_fused_pool_never_falls_back(w8):
    """A cache K1's attention block cannot hold resident goes chunked;
    with the card's memory too small for any rung the constructor raises
    with the cause (no generic step for a model with fused weights)."""
    cfg, _, _, model = w8
    wide = dataclasses.replace(cfg, language_model=dataclasses.replace(
        cfg.language_model, sliding_window=70000))
    big = VoxtralModel(model.params, wide, "cpu")
    pool = StreamPool(big, max_streams=1, unbounded=True)
    assert pool._cache_chunk == 512 and pool.cache_int8  # "auto"'s last rung
    pool = StreamPool(big, max_streams=1, unbounded=True, kv_dtype="model")
    assert pool._cache_chunk == 512 and not pool.cache_int8
    assert pool.dec_k.shape[3] % 512 == 0
    assert pool._dec_ring == (PREFIX_LEN, pool.dec_k.shape[3] - PREFIX_LEN)
    why = tstreaming._rung_refusal(big, 1, 70046, None, None, 1)
    assert "shared memory" in why
    mp = pytest.MonkeyPatch()
    mp.setenv("VOXTRAL_HBM_BYTES", str(2 ** 30))
    try:
        with pytest.raises(ValueError, match="K1 can take no rung") as e:
            StreamPool(model, max_streams=2, max_duration_s=30)
    finally:
        mp.undo()
    assert "device budget" in str(e.value) and "int8 cache" in str(e.value)
    assert isinstance(tstreaming._fused_plan(model, 2, 250), dict)


# -- the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(unbounded=True, kv_dtype="model"),
    dict(unbounded=True, kv_dtype="int8"),
    dict(max_duration_s=30, kv_dtype="int8"),
    dict(unbounded=True, kv_dtype="int8", speculative=8, draft="ngram"),
], ids=["ring-bf16", "ring-int8", "bounded-int8", "ring-int8-spec"])
def test_pool_kernels_match_plain_on_card(w8, kw):
    """A tiny pool through the kernels on the card (K1 with per-row
    rings, int8 KV; K2 at B x 4P rows) against the same pool through
    their plain versions: the same tokens, every step a K1 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from voxtral_tpu_torch.ops import decode_step as k1

    cfg, tree = w8[0], w8[1]
    model = VoxtralModel.from_numpy(tree, cfg, "cuda")
    plain = VoxtralModel(model.params, cfg, "cuda", kernels=False)
    k1.decode_stack_step.launches = 0
    got, pool, _ = scenario(StreamingSession, StreamPool, model, **kw)
    assert pool.dec_k.is_cuda
    assert k1.decode_stack_step.launches > 0
    ref, _, _ = scenario(StreamingSession, StreamPool, plain, **kw)
    assert got == ref


def test_jax_packed_q4_solo_margin_on_seed_39(q4_models, monkeypatch):
    """Whether the near tie of Q4_PACKED_SIGNALS' note is JAX's too: JAX's
    packed q4 solo session on the seed-39 signal, its top-2 logit margins
    read at every lm_head call of its steps (its own jitted steps, traced
    anew around a recording ``lm_head``; nothing of the JAX package is
    edited).  It is not: both sessions are closest at the same position
    and emit the same tokens, but JAX's margin there is 0.096, above
    Q4_MIN_MARGIN, and the port's 0.036 under it (the parting of K3's
    summation order, ROADMAP §3)."""
    jmodel, model = q4_models["q4"]
    margins = []
    orig = jstreaming.lm_head

    def record(logits):
        top2 = np.sort(np.asarray(logits, np.float64).reshape(
            -1, logits.shape[-1]), axis=-1)[:, -2:]
        margins.extend((top2[:, 1] - top2[:, 0]).tolist())

    def lm_head(*args, **kw):
        logits = orig(*args, **kw)
        jax.debug.callback(record, logits)
        return logits

    monkeypatch.setattr(jstreaming, "lm_head", lm_head)
    monkeypatch.setattr(jstreaming, "_STEP_JIT_CACHE", {})
    sig = audio(4, 39)
    ref = JaxSession(jmodel, unbounded=True)
    ref.feed(sig)
    ref.finish()
    jax.effects_barrier()
    model.record_margins = True
    ses = StreamingSession(model, unbounded=True)
    ses.feed(sig)
    ses.finish()
    assert ses.tokens == ref.tokens
    assert len(margins) == len(ses.margins) == len(ref.tokens)
    assert int(np.argmin(margins)) == int(np.argmin(ses.margins))
    assert min(margins) > Q4_MIN_MARGIN > min(ses.margins)
