"""Live streaming on a mesh: K4's head+ring, int8 and chunked cache modes,
``tp_decode_step`` in those modes, and ``StreamingSession`` /
``StreamPool`` at tp = 2, dp = 2 and 2 x 2, against the JAX package.

The JAX side runs its Pallas halves and stack kernel in interpret mode
(``VOXTRAL_MEGAKERNEL=force``) on the 8-device virtual CPU mesh of
``tests/conftest.py``; the port runs its plain versions on a mesh of
CPUs (``["cpu"] * n``).  Rules (ROADMAP §3):

* K4 alone and ``tp_decode_step``: the stacks of
  ``tests/test_torch_decode_step.py`` (3 layers, D 256, 8 query / 2 KV
  heads, tp = 2), K1's tolerances against JAX: 1e-5 of the largest value
  for the partials and x_out (f32 summation order), one bf16 ulp for
  k_new / v_new.  The int8 caches are JAX's ``quantize_kv`` codes and
  scales on both sides (every int8 dot is an integer sum).
* Sessions and pools: the tiny w8 model of ``tests/test_torch_pool.py``
  and its audio.  "Holding TP against the single card": a TP run is held
  to JAX's TP run (the same local-absmax quantization), tokens equal,
  with every top-2 margin of the port's TP run above ``TP_MIN_MARGIN``
  so that a flip could be told from a fault.  A DP pool equals the
  single-device pool exactly, a 2 x 2 pool the tp = 2 pool exactly, a
  solo session on a 2 x 2 mesh the tp = 2 session exactly; speculative
  equals sequential (the spec near-tie rule, exact on these margins).
* The meshed pool's checkpoint, on the inputs of JAX's own test,
  restores into a single-device solo session on the per-op step and into
  the JAX package, and continues with the uninterrupted session's
  tokens; on K1's step, up to a flip below ``LAYOUT_TIE``.

The ``cuda`` tests hold K4 in each mode, a meshed session and a meshed
pool, kernel against plain, on the card; they skip here.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import voxtral_tpu.streaming as jstreaming
import voxtral_tpu_torch.streaming as tstreaming
from tests.test_torch_decode_step import (
    D, EPS, HEAD_DIM, HIDDEN, KV_RTOL, L, N_HEADS, N_KV, S, X_RTOL, to_torch,
)
from tests.test_torch_pool import SIGNALS, audio, scenario
from tests.test_torch_tp import (  # noqa: F401  (setup is a fixture)
    NH_L, NKV_L, TP, _close, _rope, _rows, _shard_cache, setup,
)
from voxtral_tpu.ops import decode_step_pallas as jdsp
from voxtral_tpu.ops import decode_tp_pallas as jtp
from voxtral_tpu.parallel import make_mesh as jax_make_mesh
from voxtral_tpu_torch.ops import decode_tp as ttp
from voxtral_tpu_torch.parallel import make_mesh
from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

# JAX's ring case (tests/test_parallel.py:479): a 4-slot head and an
# 8-slot ring inside S = 16 slots, window 8.
RING = (4, 8)
TP_MIN_MARGIN = 0.05
STREAM_SIGNALS = (audio(6, 3), audio(4, 5), audio(4, 7))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K4 alone in each new mode
# ---------------------------------------------------------------------------

# (offsets, spec, window, ring, int8, chunk)
K4_MODES = {
    "ring": ([20, 13], 1, 8, RING, False, None),        # past / before the wrap
    "ring_spec": ([14, 27], 3, 8, RING, False, None),   # rows straddle the ring
    "int8": ([3, 12], 1, 8, None, True, None),
    "int8_ring": ([40, 14], 1, 8, RING, True, None),    # the head left the window
    "int8_spec": ([5, 11], 3, None, None, True, None),  # one requant group
    "chunk": ([7, 16], 1, 8, None, False, 8),
    "int8_chunk": ([15, 14], 1, 4, None, True, 4),      # chunks below the band
    "int8_chunk_ring": ([40, 5], 1, 8, RING, True, 4),
}


def _k4_case(setup, mode, shard=1, layer=1):
    """(JAX's outputs, the port's args and kwargs) of K4 on one shard."""
    offs, spec, window, ring, int8, chunk = K4_MODES[mode]
    jtw, ttw = setup["jtw"], setup["ttw"]
    cos, sin = _rope(offs, spec)
    x = _rows(setup["x"], len(offs) * spec)
    heads = slice(shard * NKV_L, (shard + 1) * NKV_L)
    streams = np.arange(len(offs)) % setup["k"].shape[1]
    kc = jnp.asarray(setup["k"][:, streams][:, :, heads])  # [L, Bc, ...]
    vc = jnp.asarray(setup["v"][:, streams][:, :, heads])
    scales = (None, None)
    if int8:
        (kc, ks), (vc, vs) = jdsp.quantize_kv(kc), jdsp.quantize_kv(vc)
        scales = (ks[layer], vs[layer])
    an = np.asarray(setup["jf"]["attn_norm"][layer])
    kw = dict(n_heads_l=NH_L, n_kv_l=NKV_L, head_dim=HEAD_DIM, eps=EPS,
              window=window, spec=spec, ring=ring, cache_chunk=chunk)
    # JAX's chunked mode takes the whole [L, ...] stacks; the port a layer.
    jk, jv = (kc, vc) if chunk else (kc[layer], vc[layer])
    ref = jtp.attn_half_step(
        jnp.asarray(x), layer, jnp.asarray(offs, jnp.int32), jnp.asarray(an),
        jtw["sqkv"][shard][layer], jtw["so"][shard][layer], jnp.asarray(cos),
        jnp.asarray(sin), jk, jv, jtw["wqkv"][shard], jtw["wo"][shard],
        *scales, interpret=True, **kw)

    def t(a):  # bf16 caches, int8 codes and f32 scales as JAX holds them
        if a is None or a.dtype != jnp.bfloat16:
            return None if a is None else to_torch(np.asarray(a))
        return to_torch(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    args = (to_torch(x), layer, torch.tensor(offs, dtype=torch.int32),
            to_torch(an), ttw["sqkv"][shard][layer], ttw["so"][shard][layer],
            to_torch(cos), to_torch(sin), t(kc[layer]), t(vc[layer]),
            ttw["wqkv"][shard], ttw["wo"][shard], t(scales[0]),
            t(scales[1]))
    return ref, args, kw


@pytest.mark.parametrize("mode", list(K4_MODES))
def test_attn_half_step_modes_plain_match_jax(setup, mode):
    """K4's plain version in each new mode against JAX's K4 (interpret
    mode): K1's tolerances (module docstring)."""
    ref, args, kw = _k4_case(setup, mode)
    assert args[8].dtype == (torch.int8 if K4_MODES[mode][4]
                             else torch.bfloat16)
    got = ttp.attn_half_step(*args, **kw)
    rows = len(K4_MODES[mode][0]) * kw["spec"]
    assert got[0].shape == (rows, D)
    assert got[1].dtype == torch.bfloat16  # bf16 over an int8 cache too
    _close(got[0], ref[0], X_RTOL, f"{mode} partial")
    _close(got[1], ref[1], KV_RTOL, f"{mode} k_new")
    _close(got[2], ref[2], KV_RTOL, f"{mode} v_new")


def test_attn_half_step_guards_match_jax(setup):
    """JAX's guards (``decode_tp_pallas.py:642-668``): spec x chunk, an
    int8 cache without scales, a chunk that does not divide S; and the
    geometry check for the new modes."""
    _, args, kw = _k4_case(setup, "int8_spec")
    with pytest.raises(ValueError, match="cache_chunk unsupported"):
        ttp.attn_half_step(*args, **dict(kw, cache_chunk=8))
    with pytest.raises(ValueError, match="needs k_scales"):
        ttp.attn_half_step(*args[:12], **kw)
    _, args, kw = _k4_case(setup, "chunk")
    with pytest.raises(ValueError, match="must divide S"):
        ttp.attn_half_step(*args, **dict(kw, cache_chunk=5))
    ttp.check_tp_geometry(8238, 128, 8192, 8, 8, 9216, 2,
                          (38, 8200), None, True)
    ttp.check_tp_geometry(70144, 128, 70000, 1, 8, 9216, 2,
                          (38, 70106), 512, True)  # chunked: any S
    with pytest.raises(ValueError, match="shared memory"):
        ttp.check_tp_geometry(70144, 128, 70000, 1, 8, 9216, 2,
                              (38, 70106))
    with pytest.raises(ValueError, match="does not fit"):
        ttp.check_tp_geometry(S, HEAD_DIM, 8, 1, N_KV, HIDDEN, 2,
                              (4, 13))


# ---------------------------------------------------------------------------
# tp_decode_step in the new modes
# ---------------------------------------------------------------------------


@requires_8_devices
@pytest.mark.parametrize("n_data,offs,spec,ring,int8,chunk", [
    (1, [14, 27], 2, RING, True, None),
    (2, [7, 16, 3, 12], 1, None, False, 8),
    (2, [40, 5, 20, 13], 1, RING, True, 4),
], ids=["int8-ring-spec", "dp-chunk", "dp-int8-ring-chunk"])
def test_tp_decode_step_modes_match_jax(setup, n_data, offs, spec, ring,
                                        int8, chunk):
    import ml_dtypes

    rng = np.random.default_rng(13)
    shape = (L, len(offs), N_KV, S, HEAD_DIM)
    kc = jnp.asarray((rng.normal(size=shape) * 0.4).astype(
        ml_dtypes.bfloat16))
    vc = jnp.asarray((rng.normal(size=shape) * 0.4).astype(
        ml_dtypes.bfloat16))
    x = _rows(setup["x"], len(offs) * spec)
    cos, sin = _rope(offs, spec)
    jscales = {}
    if int8:
        (kc, ks), (vc, vs) = jdsp.quantize_kv(kc), jdsp.quantize_kv(vc)
        jscales = dict(k_scales=ks, v_scales=vs)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8, spec=spec, ring=ring, cache_chunk=chunk)
    jf = setup["jf"]
    jx, jk, jv = jtp.tp_decode_step(
        jax_make_mesh(n_data, TP), jnp.asarray(x),
        jnp.asarray(offs, jnp.int32), jf["attn_norm"], jf["ffn_norm"],
        jnp.asarray(setup["adav"]), setup["jtw"], jnp.asarray(cos),
        jnp.asarray(sin), kc, vc, interpret=True,
        data_axis="data" if n_data > 1 else None, **jscales, **kw)

    mesh = make_mesh(n_data, TP, ["cpu"] * (n_data * TP))

    def grid(a):  # a JAX cache / scale stack as the port's shard grid
        t = to_torch(np.asarray(a if a.dtype != jnp.bfloat16
                                else a.astype(jnp.float32)))
        if a.dtype == jnp.bfloat16:
            t = t.to(torch.bfloat16)
        if t.dim() == 4:  # scales [L, B, Hkv, S]
            return [[g[..., 0] for g in row] for row in
                    _shard_cache(mesh, t[..., None], n_data)]
        return _shard_cache(mesh, t, n_data)

    tf = setup["tf"]
    scales = ((grid(jscales["k_scales"]), grid(jscales["v_scales"]))
              if int8 else (None, None))
    tx, tk, tv = ttp.tp_decode_step(
        mesh, to_torch(x), torch.tensor(offs, dtype=torch.int32),
        tf["attn_norm"], tf["ffn_norm"], to_torch(setup["adav"]),
        ttp.place_shards(mesh, setup["ttw"]), to_torch(cos), to_torch(sin),
        grid(kc), grid(vc), *scales, **kw)
    _close(tx, jx, X_RTOL, "x_out")
    _close(ttp.gather_kv(tk), jk, KV_RTOL, "k_new")
    _close(ttp.gather_kv(tv), jv, KV_RTOL, "v_new")


def test_tp_spec_rejects_chunked(setup):
    """JAX's ``test_tp_spec_rejects_chunked`` (``tests/test_parallel.py:
    1004``): spec x cache_chunk is refused on the TP path too."""
    mesh = make_mesh(1, TP, ["cpu"] * TP)
    tf = setup["tf"]
    cos, sin = _rope([5, 5], 2)
    k = to_torch(np.asarray(setup["k"], np.float32)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="cache_chunk"):
        ttp.tp_decode_step(
            mesh, torch.zeros((4, D)), torch.full((2,), 5, dtype=torch.int32),
            tf["attn_norm"], tf["ffn_norm"], to_torch(setup["adav"]),
            ttp.place_shards(mesh, setup["ttw"]), to_torch(cos),
            to_torch(sin), _shard_cache(mesh, k, 1), _shard_cache(mesh, k, 1),
            n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS, spec=2,
            cache_chunk=8)


# ---------------------------------------------------------------------------
# Sessions and pools on a mesh, against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def w8():
    """(config, numpy tree, {(data, model): port model}) on
    tests/test_torch_pool.py's weights."""
    from tests.test_torch_model import (
        FINAL_NORM_GAIN, SCALE, SEED, dense_params, tiny_config,
    )
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    cfg = tiny_config()
    tree = quantize_params_w8(dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN))
    models = {}
    for nd, nm in ((1, 1), (1, 2), (2, 1), (2, 2)):
        mesh = None if nd * nm == 1 else make_mesh(nd, nm, ["cpu"] * nd * nm)
        models[(nd, nm)] = VoxtralModel.from_numpy(tree, cfg, "cpu",
                                                   mesh=mesh)
        models[(nd, nm)].record_margins = True
    return cfg, tree, models


def _jax_model(w8, nd, nm):
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel

    cfg, tree, _ = w8
    mp = pytest.MonkeyPatch()
    mp.setenv("VOXTRAL_MEGAKERNEL", "force")
    try:
        return JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg,
                        mesh=jax_make_mesh(nd, nm))
    finally:
        mp.undo()


def _solo(Session, model, sig, **kw):
    s = Session(model, step_positions=8, max_duration_s=30, **kw)
    for piece in np.array_split(sig, 4):
        s.feed(piece)
    s.finish()
    return s


@requires_8_devices
@pytest.mark.parametrize("unbounded,spec", [(True, 0), (False, 4)],
                         ids=["ring", "bounded-spec4"])
def test_tp_session_matches_jax(w8, unbounded, spec):
    """A solo session on a tp = 2 mesh (the K4 / K5 halves, the ring mask
    when unbounded, K6's tokens) against JAX's TP session; the port's
    speculative and sequential sessions agree, and a session on the 2 x 2
    mesh (data group 0) equals the tp = 2 one."""
    models = w8[2]
    sig = STREAM_SIGNALS[0]
    kw = dict(unbounded=unbounded, speculative=spec)
    ref = _solo(jstreaming.StreamingSession, _jax_model(w8, 1, 2), sig, **kw)
    ses = _solo(StreamingSession, models[(1, 2)], sig, **kw)
    assert ses._tp_mesh is not None and len(ses._kv.k) == 1
    assert len(ses._kv.k[0]) == 2 and ses._kv.k[0][1].shape[2] == 1
    if spec:
        assert ses.spec_metrics()["passes"] > 0
    assert ses.tokens == ref.tokens
    other = _solo(StreamingSession, models[(1, 2)], sig,
                  unbounded=unbounded, speculative=4 - spec)
    assert other.tokens == ses.tokens  # spec == sequential
    assert min(other.margins) > TP_MIN_MARGIN
    dptp = _solo(StreamingSession, models[(2, 2)], sig, **kw)
    assert dptp._tp_mesh.shape == {"data": 1, "model": 2}
    assert dptp.tokens == ses.tokens


def test_tp_session_is_the_single_card_with_tp_quant_groups(w8):
    """The second witness of ROADMAP §3's TP rule (``chip_smoke.py``
    holds the card's tp = 2 streams to it on the dense-derived tree):
    the single card's step with TP's quantization groups
    (``chip_smoke.tp_quant_groups``: the WO and W2 inputs quantized per
    model shard, the partials summed in shard order) is the tp = 2
    step's arithmetic.  Its session's tokens equal the tp = 2 session's
    and its top-2 margins agree within 1e-5 (f32 summation order), where
    the single card as it is moves them by far more."""
    import chip_smoke

    cfg, tree, models = w8
    sig = STREAM_SIGNALS[0]
    single, tp = models[(1, 1)], models[(1, 2)]
    ref = _solo(StreamingSession, tp, sig, unbounded=True)
    plain = _solo(StreamingSession, single, sig, unbounded=True)
    restore = chip_smoke.tp_quant_groups(single, 2)
    try:
        grouped = _solo(StreamingSession, single, sig, unbounded=True)
    finally:
        restore()
    assert grouped.tokens == ref.tokens
    assert np.abs(np.subtract(grouped.margins, ref.margins)).max() < 1e-5
    assert np.abs(np.subtract(plain.margins, ref.margins)).max() > 1e-2


def _force_chunked(monkeypatch):
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


@requires_8_devices
@pytest.mark.parametrize("mesh,kv_dtype,chunked", [
    ((1, 2), "model", False),
    ((1, 2), "int8", False),
    ((1, 2), "auto", True),
    ((2, 1), "model", False),
    ((2, 2), "int8", False),
], ids=["tp-bf16", "tp-int8", "tp-chunked", "dp-bf16", "dp2tp2-int8"])
def test_meshed_pool_matches_jax(w8, monkeypatch, mesh, kv_dtype, chunked):
    """tests/test_torch_pool.py's scenario (two slots, three sessions,
    staggered, a slot reused, rings wrapping) on a meshed pool, tokens
    equal to JAX's meshed pool slot by slot; a DP pool also equals the
    single-device pool, a 2 x 2 pool the tp = 2 pool."""
    models = w8[2]
    if chunked:
        _force_chunked(monkeypatch)
    kw = dict(unbounded=True, kv_dtype=kv_dtype)
    ref, jpool, _ = scenario(jstreaming.StreamingSession,
                             jstreaming.StreamPool, _jax_model(w8, *mesh),
                             signals=SIGNALS, **kw)
    got, pool, sessions = scenario(StreamingSession, StreamPool,
                                   models[mesh], signals=SIGNALS, **kw)
    assert (pool._tp_mesh is not None) == (jpool._tp_mesh is not None) \
        == (mesh[1] > 1)
    assert (pool._dp_mesh is not None) == (jpool._dp_mesh is not None) \
        == (mesh == (2, 1))
    assert pool.cache_int8 == jpool.cache_int8
    assert pool._cache_chunk == jpool._cache_chunk == (64 if chunked
                                                       else None)
    assert pool._dec_ring == jpool._dec_ring
    assert got == ref
    assert min(min(s.margins) for s in sessions) > TP_MIN_MARGIN
    if mesh[1] == 1 or mesh[0] == 2:
        twin = scenario(StreamingSession, StreamPool,
                        models[(1, mesh[1])], signals=SIGNALS, **kw)[0]
        assert got == twin


def test_meshed_pool_layout_and_refusals(w8, monkeypatch):
    """The shard grids of a 2 x 2 int8 pool; the spec pool's data-axis
    guard (JAX's ``test_dp_pooled_speculative_guards``,
    ``tests/test_parallel.py:805``); a batch the data axis does not
    divide is refused rung by rung; dense meshes at tp > 1 still raise (q4g
    meshes: ``tests/test_torch_tp_q4g.py``)."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.utils.quantize import random_dense_params

    cfg, _, models = w8
    lm = cfg.language_model
    pool = StreamPool(models[(2, 2)], max_streams=4, unbounded=True,
                      kv_dtype="int8")
    assert pool._tp_mesh is not None and pool._dp_mesh is None
    S_ = sum(pool._dec_ring)
    for grid, tail in ((pool.dec_k, (lm.head_dim,)), (pool.dec_ks, ())):
        assert len(grid) == 2 and all(len(row) == 2 for row in grid)
        assert grid[1][1].shape == (lm.n_layers, 2, lm.n_kv_heads // 2,
                                    S_, *tail)
    assert sum(t.numel() * t.element_size() for t in pool._kv.tensors()) \
        + 2 * pool.enc_k.numel() * 2 + 2 * pool._init_dec_zero.k.numel() \
        * 2 == pool.cache_bytes
    dp = StreamPool(models[(2, 1)], max_streams=2, max_duration_s=30)
    assert dp._dp_mesh is not None and dp._fused["dp"] == 2
    for Pool, m in ((StreamPool, models[(2, 1)]),
                    (jstreaming.StreamPool, _jax_model(w8, 2, 1))):
        with pytest.raises(ValueError, match="divisible|fused stack"):
            Pool(m, max_streams=3, step_positions=8, max_duration_s=30,
                 speculative=4)
    with pytest.raises(ValueError, match="K1 can take no rung") as e:
        StreamPool(models[(2, 1)], max_streams=3, max_duration_s=30)
    assert "not divisible by mesh axis data=2" in str(e.value)
    with pytest.raises(ValueError, match="ROADMAP item 12.3b"):
        VoxtralModel(random_dense_params(cfg, 0, torch.bfloat16, "cpu"), cfg,
                     mesh=make_mesh(1, 2, ["cpu"] * 2))


def test_dp_pool_admitted_at_jax_size(w8, monkeypatch):
    """``check_hbm(dp=)`` spreads the row caches over the data groups as
    JAX's does: at the same budget above the weights, both packages admit
    the same cache bytes at dp = 2 and refuse them at dp = 1; a dp = 2
    pool is admitted at a budget that refuses the same pool on one
    device, and each mesh shard is held to its own budget."""
    from types import SimpleNamespace

    from voxtral_tpu.utils import hbm as jhbm
    from voxtral_tpu_torch.utils import hbm

    cfg, tree, models = w8
    jmodel = SimpleNamespace(params=jax.tree_util.tree_map(jnp.asarray,
                                                           tree))
    port = SimpleNamespace(params=models[(1, 1)].params,
                           device=torch.device("cpu"))
    weights = hbm.model_hbm_bytes(port)
    assert weights == jhbm.model_hbm_bytes(jmodel)
    monkeypatch.setenv("VOXTRAL_HBM_BYTES",
                       str(weights + hbm.WORKSPACE_BYTES + 4096))
    for cache, dp, fits in ((8192, 2, True), (8194, 2, False),
                            (8192, 1, False)):
        for mod, m in ((hbm, port), (jhbm, jmodel)):
            if fits:
                mod.check_hbm(m, cache, "a pool", rows=2, dp=dp)
            else:
                with pytest.raises(mod.HBMBudgetError):
                    mod.check_hbm(m, cache, "a pool", rows=2, dp=dp)

    # A pool: its decoder caches over the data groups, the encoder caches
    # and the init slot on the first device.
    single, dp2 = models[(1, 1)], models[(2, 1)]
    monkeypatch.delenv("VOXTRAL_HBM_BYTES")
    probe = StreamPool(single, max_streams=4, unbounded=True)
    dec = sum(t.numel() * t.element_size() for t in probe._kv.tensors())
    first = probe.cache_bytes - dec
    budget = (hbm.shard_weight_bytes(dp2, 0, 0) + hbm.WORKSPACE_BYTES
              + first + dec // 2)
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(budget))
    pool = StreamPool(dp2, max_streams=4, unbounded=True, kv_dtype="model")
    assert pool._dp_mesh is not None and pool.cache_bytes == dec + first
    # Refused by the ladder or, past it, by the constructor's admission.
    refused = (ValueError, hbm.HBMBudgetError)
    with pytest.raises(refused, match="device budget"):
        StreamPool(single, max_streams=4, unbounded=True, kv_dtype="model")
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(budget - 1))
    with pytest.raises(refused, match=r"mesh shard \(0, 0\)"):
        StreamPool(dp2, max_streams=4, unbounded=True, kv_dtype="model")


# The pooled slot's cache layout against the solo session's (JAX's own: a
# pooled step leaves its first slot empty where the solo cache holds it)
# moves the logits of a restored stream by a few 1e-3: on the inputs of
# JAX's checkpoint test, the per-op step's margin at token 40 goes from
# 3.8e-3 to 1.2e-3, K1's from 3.8e-3 to -1e-4 (a flip).
LAYOUT_TIE = 1e-2


def test_meshed_pool_checkpoint_restores_solo(monkeypatch):
    """JAX's ``test_meshed_pool_to_solo_restore``
    (``tests/test_checkpoint.py:311``) on its own inputs: the tiny config
    of ``tests/test_model.py`` with vocab 1280, ``init_random(PRNGKey(3))``
    quantized to w8, the audio of seeds 23 and 24.  A slot of a 2 x 2
    pool (the TP halves over sharded caches) snapshots to the solo layout
    (gathered from its shards) and restores as a single-device solo
    session on the per-op step (JAX's ``VOXTRAL_MEGAKERNEL=0``), which
    continues with the tokens of the uninterrupted solo session, exactly,
    as in JAX.  Restored on K1's step, it equals the restore of the same
    slot from a single-device pool exactly, and the uninterrupted session
    up to a flip where that session's top-2 margin is below LAYOUT_TIE.
    The checkpoint also restores into JAX's solo session (the same
    tokens), and JAX's solo checkpoint into slot 1 of the meshed pool
    (scattered over its shards) as into a single-device pool's."""
    import dataclasses

    from tests.test_checkpoint import _audio
    from tests.test_model import tiny_config as jax_tiny_config
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.utils.quantize import quantize_params_w8 as jax_w8
    from voxtral_tpu_torch.config import VoxtralConfig
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg = jax_tiny_config()
    cfg = dataclasses.replace(cfg, language_model=dataclasses.replace(
        cfg.language_model, vocab_size=1280))
    f32 = JaxModel.init_random(jax.random.PRNGKey(3), cfg,
                               dtype=jnp.float32)
    w8 = jax_w8(f32.params)
    tree = jax.tree_util.tree_map(np.asarray, w8)
    tcfg = VoxtralConfig.from_json(cfg.to_params_json())
    audio, other = _audio(seed=23), _audio(seconds=4, seed=24)

    single = VoxtralModel.from_numpy(tree, tcfg, "cpu")
    per_op = VoxtralModel.from_numpy(tree, tcfg, "cpu")
    per_op.fused_decode, per_op.decode_route = None, "per_op"
    dptp = VoxtralModel.from_numpy(tree, tcfg, "cpu",
                                   mesh=make_mesh(2, 2, ["cpu"] * 4))
    single.record_margins = per_op.record_margins = True

    def pooled_state(model):
        pool = StreamPool(model, max_streams=2, step_positions=8,
                          max_duration_s=30)
        pa = StreamingSession(model, step_positions=8, pool=pool)
        pb = StreamingSession(model, step_positions=8, pool=pool)
        pa.feed(audio[:60000])
        pb.feed(other)
        assert pa.positions_done > 0 and pa._slot == 0
        return pa.state_dict(), pool

    def continued(Session, model, state, **kw):
        s = Session.restore(model, state, **kw)
        s.feed(audio[60000:])
        s.finish()
        return s.tokens

    ref = StreamingSession(per_op, step_positions=8, max_duration_s=30)
    ref.feed(audio)
    ref.finish()
    state, pool = pooled_state(dptp)
    assert pool._tp_mesh is not None
    assert state["dec_k"].shape[3] == tcfg.language_model.n_kv_heads
    assert continued(StreamingSession, per_op, state) == ref.tokens

    fused = continued(StreamingSession, single, state)
    assert fused == continued(StreamingSession, single,
                              pooled_state(single)[0])
    differ = [i for i, (a, b) in enumerate(zip(fused, ref.tokens)) if a != b]
    assert len(fused) == len(ref.tokens)
    if differ:
        assert ref.margins[differ[0]] < LAYOUT_TIE, differ[0]

    with monkeypatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "0")
        jmodel = JaxModel(w8, cfg)
    assert continued(jstreaming.StreamingSession, jmodel, state) \
        == ref.tokens

    # JAX -> slot 1 of the meshed pool, against slot 1 of a single pool.
    js = jstreaming.StreamingSession(jmodel, step_positions=8,
                                     max_duration_s=30)
    js.feed(audio[:60000])
    got = []
    for model in (dptp, single):
        pool = StreamPool(model, max_streams=2, max_duration_s=30)
        StreamingSession(model, pool=pool)  # slot 0 idle
        got.append(continued(StreamingSession, model, js.state_dict(),
                             pool=pool))
    assert got[0] == got[1] and len(got[0]) > len(js.tokens)


# ---------------------------------------------------------------------------
# On the card: kernel against plain
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(K4_MODES))
def test_attn_half_step_modes_kernel_match_plain_on_card(setup, mode):
    """K4 in each new mode on the card, bit for bit with its plain version
    (f64 sums, ``-fmad=false``), one launch each."""
    dev = _card()
    _, args, kw = _k4_case(setup, mode)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)
    before = ttp.attn_half_step.launches
    got = ttp.attn_half_step(*args, **kw)
    torch.cuda.synchronize()
    assert ttp.attn_half_step.launches == before + 1
    ref = ttp.attn_half_step_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), (g - r).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,kw", [
    ((1, 2), dict(unbounded=True)),
    ((1, 2), dict(speculative=4)),
    ((2, 2), dict(unbounded=True, kv_dtype="int8", pool=True)),
    ((2, 1), dict(unbounded=True, kv_dtype="int8", pool=True)),
], ids=["tp-session-ring", "tp-session-spec", "dp2tp2-pool-int8",
        "dp-pool-int8"])
def test_meshed_streams_kernel_match_plain_on_card(w8, mesh, kw):
    """A meshed session or pool on one card (every shard on it) through
    the kernels and through their plain versions: the same tokens, the
    meshed kernels launched."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.ops import decode_step as k1

    dev = _card()
    cfg, tree, _ = w8
    kw = dict(kw)
    pooled = kw.pop("pool", False)
    runs = []
    for kernels in (True, False):
        m = VoxtralModel.from_numpy(tree, cfg, dev, kernels=kernels,
                                    mesh=make_mesh(*mesh, [dev] * (
                                        mesh[0] * mesh[1])))
        ttp.attn_half_step.launches = k1.decode_stack_step.launches = 0
        if pooled:
            runs.append(scenario(StreamingSession, StreamPool, m,
                                 signals=SIGNALS, **kw)[0])
        else:
            runs.append(_solo(StreamingSession, m, STREAM_SIGNALS[0],
                              **kw).tokens)
        if kernels:
            counter = (ttp.attn_half_step if mesh[1] > 1
                       else k1.decode_stack_step)
            assert counter.launches > 0
    assert runs[0] == runs[1]
