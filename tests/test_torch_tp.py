"""K4, K5, K6 and K1 mode (i): the port's tensor- and data-parallel decode
pieces against the JAX package.

Inputs: the tiny stacks of ``tests/test_torch_decode_step.py`` (3 layers,
D 256, 8 query / 2 KV heads of 32, hidden 512, vocab 1024), tp = 2, so a
shard holds 4 query heads, 1 KV head, 256 FFN rows and 512 vocab rows.
The JAX side runs its Pallas halves in interpret mode, its mesh on the
8-device virtual CPU mesh (``tests/conftest.py``); the port runs on the
CPU, where every wrapper takes its plain version.

* ``tp_shard_fused_weights`` / ``tp_shard_lm_head``: equal to JAX's arrays.
* K4 ``attn_half_step``, K5 ``ffn_half_step``, K6 ``lm_half_argmax``, one
  shard at a time, 1 row and spec rows, with a window: K1's tolerances
  (``test_torch_decode_step.py``), 1e-5 of the largest value for the
  partials and K6's maximum (f32 summation order; K6's norm and quant run
  in jitted XLA, which divides by 127 as a multiplication by its
  reciprocal, an ulp of ``sx`` away from the port's true division), one
  bf16 ulp for k_new / v_new; K6's indices equal.
* ``tp_decode_step`` / ``tp_lm_head_token`` on ``["cpu"] * 2`` (and a
  2 x 2 mesh with a data axis) against JAX's ``shard_map`` on the virtual
  mesh.  JAX scans the layers with ``lax.scan`` inside ``shard_map``;
  that moved no rounding that matters here: x_out measured within 2.6e-7
  of its largest value over three layers and k_new / v_new bit-equal, so
  K1's bounds hold (1e-5, one bf16 ulp).  Tokens are equal.
* K1 mode (i) (``lm_argmax=True``) plain against JAX's: tokens equal, and
  equal to the argmax of mode (a)'s logits.
* ``dp_decode_stack_step`` against the unsharded port: bit for bit.

The ``cuda`` tests hold each kernel against its plain version on the
card, bit for bit (f64 sums and ``-fmad=false``, ROADMAP §3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_decode_step import (
    B, D, EPS, HEAD_DIM, HIDDEN, KV_RTOL, L, N_HEADS, N_KV, S, V, X_RTOL,
    build_inputs, params_from_numpy, to_torch,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from voxtral_tpu.ops import decode_step_pallas as jdsp
from voxtral_tpu.ops import decode_tp_pallas as jtp
from voxtral_tpu.parallel import make_mesh as jax_make_mesh
from voxtral_tpu_torch.ops import decode_step as tdsp
from voxtral_tpu_torch.ops import decode_tp as ttp
from voxtral_tpu_torch.parallel import dp_decode_stack_step, make_mesh

TP = 2
NH_L, NKV_L = N_HEADS // TP, N_KV // TP

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def setup():
    """Inputs, JAX's fused and TP stacks, the port's, ADA vectors."""
    params, t_embed, k_cache, v_cache, x, lm, final_norm = build_inputs()
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    jf = jdsp.fuse_decode_weights(jtree)
    jtw = jtp.tp_shard_fused_weights(jf, N_HEADS, N_KV, HEAD_DIM, HIDDEN, TP)
    adav = np.asarray(jdsp.ada_vectors(jtree, jnp.asarray(t_embed)))
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    ttw = ttp.tp_shard_fused_weights(tf, N_HEADS, N_KV, HEAD_DIM, HIDDEN, TP)
    return dict(params=params, k=k_cache, v=v_cache, x=x, lm=lm,
                fnorm=final_norm, jf=jf, jtw=jtw, adav=adav, tf=tf, ttw=ttw)


def _close(got, ref, rtol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max(), err_msg=what)


def _rope(offs, spec):
    pos = (np.asarray(offs)[:, None] + np.arange(spec)[None]).reshape(-1)
    c, s = jax.vmap(lambda q: jdsp.rope_pair_vectors(
        q, HEAD_DIM, theta=1e6))(jnp.asarray(pos, jnp.int32))
    return np.asarray(c), np.asarray(s)


def _rows(x, n):
    return np.resize(x, (n, D)).astype(np.float32) * np.linspace(
        0.7, 1.3, n, dtype=np.float32)[:, None]


def test_tp_shard_fused_weights_equal_jax(setup):
    assert set(setup["ttw"]) == set(setup["jtw"])
    for name, ref in setup["jtw"].items():
        got = setup["ttw"][name]
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=name)


def test_tp_shard_lm_head_equals_jax(setup):
    lm = setup["lm"]
    ref = jtp.tp_shard_lm_head({"codes": jnp.asarray(lm["codes"]),
                                "scale": jnp.asarray(lm["scale"])}, TP)
    got = ttp.tp_shard_lm_head({"codes": to_torch(lm["codes"]),
                                "scale": to_torch(lm["scale"])}, TP)
    for name in ("codes", "scale"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]))
    with pytest.raises(ValueError, match="must divide vocab"):
        ttp.tp_shard_lm_head({"codes": to_torch(lm["codes"]),
                              "scale": to_torch(lm["scale"])}, 3)


def _attn_case(setup, shard, offs, spec, window, layer=1):
    jtw, ttw = setup["jtw"], setup["ttw"]
    cos, sin = _rope(offs, spec)
    x = _rows(setup["x"], len(offs) * spec)
    heads = slice(shard * NKV_L, (shard + 1) * NKV_L)
    streams = np.arange(len(offs)) % B
    kc = setup["k"][layer][streams][:, heads]
    vc = setup["v"][layer][streams][:, heads]
    an = np.asarray(setup["jf"]["attn_norm"][layer])
    kw = dict(n_heads_l=NH_L, n_kv_l=NKV_L, head_dim=HEAD_DIM, eps=EPS,
              window=window, spec=spec)
    ref = jtp.attn_half_step(
        jnp.asarray(x), layer, jnp.asarray(offs, jnp.int32), jnp.asarray(an),
        jtw["sqkv"][shard][layer], jtw["so"][shard][layer], jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(kc), jnp.asarray(vc),
        jtw["wqkv"][shard], jtw["wo"][shard], interpret=True, **kw)
    args = (to_torch(x), layer, torch.tensor(offs, dtype=torch.int32),
            to_torch(an), ttw["sqkv"][shard][layer], ttw["so"][shard][layer],
            to_torch(cos), to_torch(sin), to_torch(kc), to_torch(vc),
            ttw["wqkv"][shard], ttw["wo"][shard])
    return ref, args, kw


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("offs,spec,window", [
    ([9], 1, None),        # one row
    ([5, 11], 1, 4),       # offsets per row, the window binds
    ([5, 11], 3, 4),       # spec rows: fresh rows i < j of the stream
    ([12], 4, 1),          # the window drops fresh rows past j - 1
])
def test_attn_half_step_plain_matches_jax(setup, shard, offs, spec, window):
    ref, args, kw = _attn_case(setup, shard, offs, spec, window)
    got = ttp.attn_half_step(*args, **kw)
    rows = len(offs) * spec
    assert got[0].shape == (rows, D)
    assert got[1].dtype == torch.bfloat16
    assert got[1].shape == (rows, NKV_L, HEAD_DIM)
    _close(got[0], ref[0], X_RTOL, "partial")
    _close(got[1], ref[1], KV_RTOL, "k_new")
    _close(got[2], ref[2], KV_RTOL, "v_new")


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("rows", [1, 6])
def test_ffn_half_step_plain_matches_jax(setup, shard, rows):
    jtw, ttw, layer = setup["jtw"], setup["ttw"], 2
    x = _rows(setup["x"], rows)
    fn = np.asarray(setup["jf"]["ffn_norm"][layer])
    ada = setup["adav"][layer]
    ref = jtp.ffn_half_step(
        jnp.asarray(x), layer, jnp.asarray(fn), jnp.asarray(ada),
        jtw["s13"][shard][layer], jtw["s2"][shard][layer], jtw["w13"][shard],
        jtw["w2"][shard], eps=EPS, interpret=True)
    got = ttp.ffn_half_step(
        to_torch(x), layer, to_torch(fn), to_torch(ada),
        ttw["s13"][shard][layer], ttw["s2"][shard][layer], ttw["w13"][shard],
        ttw["w2"][shard], eps=EPS)
    assert got.shape == (rows, D) and got.dtype == torch.float32
    _close(got, ref, X_RTOL, "partial")


def _lm_table(setup, tie_rows=()):
    """The lm table with rows ``tie_rows`` made equal to the last one of
    them and dominant for a positive query (a planted tie)."""
    codes = setup["lm"]["codes"].copy()
    scale = setup["lm"]["scale"].copy()
    if tie_rows:
        top = tie_rows[-1]
        codes[top] = np.abs(codes[top]).astype(np.int8)
        codes[top][codes[top] == 0] = 1
        scale[top] = scale.max() * 4.0
        for r in tie_rows[:-1]:
            codes[r], scale[r] = codes[top], scale[top]
    return codes, scale


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("ties,first", [((), None), ((70, 300), (70, None)),
                                        ((100, 900), (100, 388))])
def test_lm_half_argmax_plain_matches_jax(setup, rows, ties, first):
    """Per shard: the maximum within 1e-5, the first local index equal;
    (70, 300) plants a tie inside shard 0, (100, 900) one across the
    shards (local rows 100 of shard 0 and 388 of shard 1)."""
    codes, scale = _lm_table(setup, ties)
    x = np.abs(_rows(setup["x"], rows))
    fnorm = np.abs(setup["fnorm"])
    vl = V // TP
    for shard in range(TP):
        part = slice(shard * vl, (shard + 1) * vl)
        jv, ji = jtp.lm_half_argmax(
            jnp.asarray(x), jnp.asarray(fnorm), jnp.asarray(scale[part]),
            jnp.asarray(codes[part]), eps=EPS, interpret=True)
        tv, ti = ttp.lm_half_argmax(
            to_torch(x), to_torch(fnorm), to_torch(scale[part]),
            to_torch(codes[part]), eps=EPS)
        assert tv.shape == (rows, 1) and ti.dtype == torch.int32
        _close(tv, jv, X_RTOL, f"max of shard {shard}")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if first is not None and first[shard] is not None:
            assert ti.ravel().tolist() == [first[shard]] * rows


def _mesh_inputs(setup, offs, spec):
    x = _rows(setup["x"], len(offs) * spec)
    cos, sin = _rope(offs, spec)
    rng = np.random.default_rng(9)
    import ml_dtypes
    shape = (L, len(offs), N_KV, S + spec - 1, HEAD_DIM)
    kc = (rng.normal(size=shape) * 0.4).astype(ml_dtypes.bfloat16)
    vc = (rng.normal(size=shape) * 0.4).astype(ml_dtypes.bfloat16)
    return x, cos, sin, kc, vc


def _shard_cache(mesh, cache, n_data):
    """A head-major cache [L, B, Hkv, S, hd] as the grid [d][i] of data
    group d's streams and model shard i's KV heads."""
    per, kl = cache.shape[1] // n_data, N_KV // TP
    return [[cache[:, d * per:(d + 1) * per, i * kl:(i + 1) * kl]
             .contiguous() for i in range(TP)] for d in range(n_data)]


@requires_8_devices
@pytest.mark.parametrize("n_data,offs,spec", [
    (1, [9], 1),
    (1, [5, 11], 3),
    (2, [5, 11, 3, 14], 1),   # DP x TP: the streams split over data
    (2, [4, 12], 2),
])
def test_tp_decode_step_and_token_match_jax(setup, n_data, offs, spec):
    x, cos, sin, kc, vc = _mesh_inputs(setup, offs, spec)
    jf, adav = setup["jf"], setup["adav"]
    window, da = 6, ("data" if n_data > 1 else None)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=window, spec=spec)
    jmesh = jax_make_mesh(n_data, TP)
    jx, jk, jv = jtp.tp_decode_step(
        jmesh, jnp.asarray(x), jnp.asarray(offs, jnp.int32),
        jf["attn_norm"], jf["ffn_norm"], jnp.asarray(adav), setup["jtw"],
        jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kc), jnp.asarray(vc),
        interpret=True, data_axis=da, **kw)
    codes, scale = _lm_table(setup, (100, 900))
    jlm = jtp.tp_shard_lm_head({"codes": jnp.asarray(codes),
                                "scale": jnp.asarray(scale)}, TP)
    jtok = jtp.tp_lm_head_token(jmesh, jx, jnp.asarray(setup["fnorm"]),
                                jlm["codes"], jlm["scale"], eps=EPS,
                                interpret=True, data_axis=da)

    mesh = make_mesh(n_data, TP, ["cpu"] * (n_data * TP))
    tf = setup["tf"]
    k_sh = _shard_cache(mesh, to_torch(kc), n_data)
    v_sh = _shard_cache(mesh, to_torch(vc), n_data)
    tx, tk, tv = ttp.tp_decode_step(
        mesh, to_torch(x), torch.tensor(offs, dtype=torch.int32),
        tf["attn_norm"], tf["ffn_norm"], to_torch(adav),
        ttp.place_shards(mesh, setup["ttw"]), to_torch(cos), to_torch(sin),
        k_sh, v_sh, **kw)
    _close(tx, jx, X_RTOL, "x_out")
    _close(ttp.gather_kv(tk), jk, KV_RTOL, "k_new")
    _close(ttp.gather_kv(tv), jv, KV_RTOL, "v_new")
    tlm = ttp.place_shards(mesh, ttp.tp_shard_lm_head(
        {"codes": to_torch(codes), "scale": to_torch(scale)}, TP))
    ttok = ttp.tp_lm_head_token(mesh, tx, to_torch(setup["fnorm"]),
                                tlm["codes"], tlm["scale"], eps=EPS)
    assert ttok.dtype == torch.int32 and ttok.shape == (len(offs) * spec,)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_argmax_resolve_takes_the_lowest_global_index():
    from voxtral_tpu_torch.parallel import argmax_resolve

    vals = [torch.tensor([[2.0], [1.0], [3.0]]),
            torch.tensor([[2.0], [5.0], [1.0]])]
    idx = [torch.tensor([[7], [0], [3]], dtype=torch.int32),
           torch.tensor([[1], [4], [2]], dtype=torch.int32)]
    assert argmax_resolve(vals, idx, 10).tolist() == [7, 14, 3]


def _k1_args(setup, offs, spec, lm_codes=None, lm_scale=None):
    x, cos, sin, kc, vc = _mesh_inputs(setup, offs, spec)
    tf = setup["tf"]
    codes = setup["lm"]["codes"] if lm_codes is None else lm_codes
    scale = setup["lm"]["scale"] if lm_scale is None else lm_scale
    return dict(x=x, cos=cos, sin=sin, kc=kc, vc=vc, codes=codes,
                scale=scale, tf=tf)


@pytest.mark.parametrize("offs,spec", [([9], 1), ([5, 11], 3)])
def test_k1_lm_argmax_plain_matches_jax(setup, offs, spec):
    a = _k1_args(setup, offs, spec, *_lm_table(setup, (100, 900)))
    jf, adav = setup["jf"], setup["adav"]
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=6, spec=spec)
    x = np.abs(a["x"])
    ref = jdsp.decode_stack_step(
        jnp.asarray(x), jnp.asarray(offs, jnp.int32), jf["attn_norm"],
        jf["ffn_norm"], jnp.asarray(adav), jf["sqkv"], jf["so"], jf["s13"],
        jf["s2"], jnp.asarray(a["cos"]), jnp.asarray(a["sin"]),
        jnp.asarray(a["kc"]), jnp.asarray(a["vc"]), jf["wqkv"], jf["wo"],
        jf["w13"], jf["w2"], final_norm=jnp.asarray(setup["fnorm"]),
        lm_codes=jnp.asarray(a["codes"]), lm_scale=jnp.asarray(a["scale"]),
        interpret=True, lm_argmax=True, **kw)
    tf = a["tf"]
    args = (to_torch(x), torch.tensor(offs, dtype=torch.int32),
            tf["attn_norm"], tf["ffn_norm"], to_torch(adav), tf["sqkv"],
            tf["so"], tf["s13"], tf["s2"], to_torch(a["cos"]),
            to_torch(a["sin"]), to_torch(a["kc"]), to_torch(a["vc"]),
            tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
            to_torch(setup["fnorm"]), to_torch(a["codes"]),
            to_torch(a["scale"]))
    got = tdsp.decode_stack_step(*args, lm_argmax=True, **kw)
    assert got[3].dtype == torch.int32 and got[3].shape == (len(x), 1)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    logits = tdsp.decode_stack_step(*args, **kw)[3]
    assert got[3][:, 0].tolist() == logits.argmax(-1).tolist()
    # Without the lm fold the flag is dropped, as in JAX.
    assert len(tdsp.decode_stack_step(*args[:17], lm_argmax=True, **kw)) == 3


def test_k1_lm_argmax_guard():
    """Mode (i) needs the lm fold (JAX drops the flag without it); it
    takes any table, bf16 included."""
    assert tdsp._check_lm_argmax(True, None) is False
    assert tdsp._check_lm_argmax(False, torch.zeros(1)) is False
    assert tdsp._check_lm_argmax(True, torch.zeros(1)) is True
    assert tdsp._check_lm_argmax(True, torch.zeros(1,
                                                   dtype=torch.bfloat16))


@pytest.mark.parametrize("spec,lm_argmax", [(1, False), (1, True),
                                            (2, True)])
def test_dp_decode_stack_step_equals_unsharded(setup, spec, lm_argmax):
    """Each data group's K1 on its rows == the whole batch's K1, bit for
    bit (rows are independent in every op of the step)."""
    offs = [5, 11, 3, 14]
    a = _k1_args(setup, offs, spec)
    tf = a["tf"]
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=6, spec=spec, lm_argmax=lm_argmax)
    offs_t = torch.tensor(offs, dtype=torch.int32)
    common = (tf["attn_norm"], tf["ffn_norm"], to_torch(setup["adav"]),
              tf["sqkv"], tf["so"], tf["s13"], tf["s2"], to_torch(a["cos"]),
              to_torch(a["sin"]))
    weights = (tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
               to_torch(setup["fnorm"]), to_torch(a["codes"]),
               to_torch(a["scale"]))
    kc, vc = to_torch(a["kc"]), to_torch(a["vc"])
    ref = tdsp.decode_stack_step(to_torch(a["x"]), offs_t, *common, kc, vc,
                                 *weights, **kw)
    mesh = make_mesh(2, 1, ["cpu", "cpu"])
    got = dp_decode_stack_step(
        mesh, to_torch(a["x"]), offs_t, *common,
        [kc[:, :2].contiguous(), kc[:, 2:].contiguous()],
        [vc[:, :2].contiguous(), vc[:, 2:].contiguous()], *weights, **kw)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(torch.cat(got[1], dim=1), ref[1])
    assert torch.equal(torch.cat(got[2], dim=1), ref[2])
    assert torch.equal(got[3], ref[3])
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        dp_decode_stack_step(make_mesh(3, 1, ["cpu"] * 3), to_torch(a["x"]),
                             offs_t, *common, [kc] * 3, [vc] * 3, *weights,
                             **kw)


def test_check_tp_geometry():
    """tp divides the KV heads and the FFN rows; the vocabulary need not
    split (the whole lm_head then runs on the first device, as JAX's)."""
    ttp.check_tp_geometry(200, 128, 8192, 8, 8, 9216, 2)
    with pytest.raises(ValueError, match="must divide"):
        ttp.check_tp_geometry(200, 128, 8192, 1, 8, 9216, 3)
    with pytest.raises(ValueError, match="must divide"):
        ttp.check_tp_geometry(200, 128, 8192, 1, 8, 9215, 2)
    with pytest.raises(ValueError, match="shared memory"):
        ttp.check_tp_geometry(80000, 128, None, 1, 8, 9216, 2)


def test_wrappers_on_cpu_count_no_launch(setup):
    before = (ttp.attn_half_step.launches, ttp.ffn_half_step.launches,
              ttp.lm_half_argmax.launches)
    ref, args, kw = _attn_case(setup, 0, [9], 1, None)
    assert all(torch.equal(g, r) for g, r in zip(
        ttp.attn_half_step(*args, **kw),
        ttp.attn_half_step_plain(*args, **kw)))
    assert (ttp.attn_half_step.launches, ttp.ffn_half_step.launches,
            ttp.lm_half_argmax.launches) == before


@pytest.mark.parametrize("fmt", ["w8", "g32"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 8, 9, 32])
def test_tp_gemv_plan_bits(fmt, rows):
    """Every linear gets launch bits the kernel knows; the fused GEMV only
    for wo and w2 at one w8 row, two weight rows a warp only in w8 up to
    2 rows, the tensor-core route only for wo at 8 w8 rows, the SwiGLU in
    the GEMV's epilogue only for w13 (w8 up to 8 rows, g32 at 2-4); the
    first linear of each half goes ahead of the residual add."""
    known = (ttp.PLAN_FUSED | ttp.PLAN_PAIR | ttp.PLAN_MMA | ttp.PLAN_AHEAD
             | ttp.PLAN_GEMV_AHEAD | ttp.PLAN_SWIGLU)
    plans = {lin: ttp.tp_gemv_plan(fmt, rows, lin)
             for lin in ttp.TP_LINEARS}
    for lin, plan in plans.items():
        assert plan & ~known == 0
        w8 = fmt == "w8"
        assert bool(plan & ttp.PLAN_FUSED) == (
            lin in ("wo", "w2") and w8 and rows == 1)
        assert not plan & ttp.PLAN_PAIR or (w8 and rows <= 2)
        assert bool(plan & ttp.PLAN_MMA) == (lin == "wo" and w8 and rows == 8)
        gated = rows <= 8 if w8 else 2 <= rows <= 4
        assert bool(plan & ttp.PLAN_SWIGLU) == (lin == "w13" and gated)
        assert plan & ttp.PLAN_GEMV_AHEAD or plan & ttp.PLAN_FUSED
    for lin in ("qkv", "w13"):
        assert plans[lin] & ttp.PLAN_AHEAD


@pytest.mark.parametrize("bad", [("w4", 1, "qkv"), ("w8", 0, "qkv"),
                                 ("g32", 1, "lm")])
def test_tp_gemv_plan_refuses(bad):
    fmt, rows, lin = bad
    with pytest.raises(ValueError):
        ttp.tp_gemv_plan(fmt, rows, lin)


@pytest.mark.parametrize("fmt", ["w8", "g32"])
def test_tp_gemv_plan_reaches_every_route(fmt):
    """At the row counts the card tests run (1, 2, 3, 4, 8) the rule picks
    every route tp_linear keeps for the format (w8: the fused GEMV, two
    weight rows a warp, the tensor-core GEMV; both: the gated w13, the
    row kernel ahead or after its predecessor), so holding the chosen
    plans to the plain version on the card covers them all."""
    seen = {ttp.tp_gemv_plan(fmt, rows, lin) for rows in (1, 2, 3, 4, 8)
            for lin in ttp.TP_LINEARS}
    flags = [ttp.PLAN_AHEAD, ttp.PLAN_GEMV_AHEAD, ttp.PLAN_SWIGLU]
    if fmt == "w8":
        flags += [ttp.PLAN_FUSED, ttp.PLAN_PAIR, ttp.PLAN_MMA]
    for flag in flags:
        assert any(plan & flag for plan in seen)
    assert ttp.PLAN_GEMV_AHEAD in seen  # the row kernel after its predecessor
    assert any(plan & ttp.PLAN_SWIGLU == 0 and plan & ttp.PLAN_AHEAD
               for plan in seen)


def test_tp_scratch_is_kept_per_device_stream_and_shape():
    """The halves' scratch: one allocation per (device, stream, shape),
    handed back on the next call of that shape."""
    f32 = torch.float32
    specs = (((2, 8), torch.int8), ((2,), f32))
    a = ttp._scratch(torch.device("cpu"), 0, ("K5", 2, 8, 4), specs)
    assert [t.shape for t in a] == [(2, 8), (2,)]
    assert ttp._scratch(torch.device("cpu"), 0, ("K5", 2, 8, 4), specs) is a
    b = ttp._scratch(torch.device("cpu"), 1, ("K5", 2, 8, 4), specs)
    c = ttp._scratch(torch.device("cpu"), 0, ("K5", 3, 8, 4), specs)
    assert b is not a and c is not a


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _to(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _bit_equal(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r), (g - r).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec,window", [
    ([9], 1, None), ([5, 11], 1, 4), ([5, 11], 3, 4), ([2, 7, 9, 13], 4, 6),
])
def test_attn_half_step_kernel_matches_plain_on_card(setup, offs, spec,
                                                     window):
    dev = _card()
    _, args, kw = _attn_case(setup, 1, offs, spec, window)
    args = _to(args, dev)
    before = ttp.attn_half_step.launches
    got = ttp.attn_half_step(*args, **kw)
    torch.cuda.synchronize()
    assert ttp.attn_half_step.launches == before + 1
    _bit_equal(got, ttp.attn_half_step_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 12])
def test_ffn_half_step_kernel_matches_plain_on_card(setup, rows):
    dev = _card()
    ttw, layer = setup["ttw"], 0
    args = _to((to_torch(_rows(setup["x"], rows)), layer,
                setup["tf"]["ffn_norm"][layer],
                to_torch(setup["adav"][layer]), ttw["s13"][1][layer],
                ttw["s2"][1][layer], ttw["w13"][1], ttw["w2"][1]), dev)
    got = ttp.ffn_half_step(*args, eps=EPS)
    torch.cuda.synchronize()
    _bit_equal([got], [ttp.ffn_half_step_plain(*args, eps=EPS)])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 11])
@pytest.mark.parametrize("ties", [(), (70, 300)])
def test_lm_half_argmax_kernel_matches_plain_on_card(setup, rows, ties):
    dev = _card()
    codes, scale = _lm_table(setup, ties)
    vl = V // TP
    args = _to((to_torch(np.abs(_rows(setup["x"], rows))),
                to_torch(np.abs(setup["fnorm"])), to_torch(scale[:vl]),
                to_torch(codes[:vl])), dev)
    got = ttp.lm_half_argmax(*args, eps=EPS)
    torch.cuda.synchronize()
    _bit_equal(got, ttp.lm_half_argmax_plain(*args, eps=EPS))


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec", [([9], 1), ([5, 11], 3),
                                       ([1, 4, 6, 9], 4)])
def test_k1_lm_argmax_kernel_matches_plain_on_card(setup, offs, spec):
    dev = _card()
    a = _k1_args(setup, offs, spec, *_lm_table(setup, (100, 900)))
    tf = a["tf"]
    args = _to((to_torch(np.abs(a["x"])),
                torch.tensor(offs, dtype=torch.int32), tf["attn_norm"],
                tf["ffn_norm"], to_torch(setup["adav"]), tf["sqkv"],
                tf["so"], tf["s13"], tf["s2"], to_torch(a["cos"]),
                to_torch(a["sin"]), to_torch(a["kc"]), to_torch(a["vc"]),
                tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
                to_torch(setup["fnorm"]), to_torch(a["codes"]),
                to_torch(a["scale"])), dev)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=6, spec=spec)
    before = tdsp.decode_stack_step.argmax_launches
    got = tdsp.decode_stack_step(*args, lm_argmax=True, **kw)
    torch.cuda.synchronize()
    assert tdsp.decode_stack_step.argmax_launches == before + 1
    _bit_equal(got, tdsp.decode_stack_step_plain(*args, lm_argmax=True,
                                                 **kw))
    logits = tdsp.decode_stack_step(*args, **kw)[3]
    assert got[3][:, 0].tolist() == logits.argmax(-1).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec,ring,int8", [
    ([600, 640], 1, None, False),                  # window full
    ([30, 300, 660, 1500], 1, (40, 600), False),   # (d), four ring phases
    ([30, 300, 660, 1500], 1, (40, 600), True),    # (e)
    ([30, 296, 660, 1500], 4, (40, 600), True),    # (e) x (b)
])
def test_attn_half_step_cluster_kernel_matches_plain_on_card(
        setup, offs, spec, ring, int8):
    """K4 through the cluster attention over a 640-slot local cache (the
    slots split over up to 10 blocks of 64-slot tiles, 4 at the bounded
    cache's 256-slot window), bit-equal to its plain version."""
    dev = _card()
    _, args, kw = _attn_case(setup, 0, [9], 1, None)
    bc, S = len(offs), 640
    g = torch.Generator(device="cpu").manual_seed(3 + bc * spec)
    x = torch.randn((bc * spec, D), generator=g) * 0.5
    off = torch.tensor(offs, dtype=torch.int32)
    pos = (off[:, None] + torch.arange(spec)).reshape(-1)
    c, s = tdsp.rope_pair_vectors(pos, HEAD_DIM)
    kc = (torch.randn((bc, NKV_L, S, HEAD_DIM), generator=g) * 0.4).bfloat16()
    vc = (torch.randn((bc, NKV_L, S, HEAD_DIM), generator=g) * 0.4).bfloat16()
    scales = ()
    if int8:
        (kc, ks), (vc, vs) = tdsp.quantize_kv(kc), tdsp.quantize_kv(vc)
        scales = (ks, vs)
    args = _to((x, args[1], off, *args[3:6], c, s, kc, vc, *args[10:12],
                *scales), dev)
    kw = dict(kw, window=256, spec=spec, ring=ring)
    got = ttp.attn_half_step(*args, **kw)
    torch.cuda.synchronize()
    _bit_equal(got, ttp.attn_half_step_plain(*args, **kw))


# -- full width: the chain and plain stream order, every row count and mode --

# Voxtral Mini 4B's decoder at tp = 2: a shard's 16 query and 4 kv heads
# of 128, D 3072, 4608 of the 9216 hidden rows.
FULL_D, FULL_NH_L, FULL_NKV_L, FULL_HD, FULL_F_L = 3072, 16, 4, 128, 4608
FULL_LAYER = 1
# mode -> (S, ring, int8, chunk); the offsets per row count below.
FULL_MODES = {"bounded": (194, None, False, None),
              "ring": (640, (40, 600), False, None),
              "int8": (640, (40, 600), True, None),
              "chunk": (1536, None, False, 512)}
FULL_OFFS = {"bounded": [187, 150, 120, 60, 30, 9, 100, 170],
             "ring": [30, 300, 660, 1500, 639, 641, 100, 1000],
             "chunk": [7, 700, 1100, 1536, 512, 1024, 300, 900]}


def full_width_stacks(fmt: str, dev, seed: int = 0) -> dict:
    """Random local stacks of one tp = 2 shard at full width, two layers
    (layer FULL_LAYER read): int8 codes with f32 row scales (w8) or f16
    group scales (g32), the norms and an ADA vector."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nq, nkv = FULL_NH_L * FULL_HD, FULL_NKV_L * FULL_HD
    nqkv = nq + 2 * nkv

    def codes(*shape):
        return torch.randint(-127, 128, (2, *shape), dtype=torch.int8,
                             device=dev, generator=g)

    def scales(n, k):
        if fmt == "g32":
            return (torch.rand((n, k // 32), device=dev, generator=g)
                    * 2e-3 + 1e-4).half()
        return torch.rand((n,), device=dev, generator=g) * 4e-4 + 1e-5

    def vec():
        return 1 + 0.1 * torch.randn((FULL_D,), device=dev, generator=g)

    return {"wqkv": codes(nqkv, FULL_D), "sqkv": scales(nqkv, FULL_D),
            "wo": codes(FULL_D, nq), "so": scales(FULL_D, nq),
            "w13": codes(2 * FULL_F_L, FULL_D),
            "s13": scales(2 * FULL_F_L, FULL_D),
            "w2": codes(FULL_D, FULL_F_L), "s2": scales(FULL_D, FULL_F_L),
            "attn_norm": vec(), "ffn_norm": vec(), "ada": vec()}


def full_k4_case(w: dict, rows: int, mode: str, dev):
    """K4's arguments at ``rows`` rows in cache ``mode``: one stream per
    row (spec 1; rows 1 with a scalar offset), and at 8 rows on the
    bounded and ring caches one and two streams of spec rows."""
    S, ring, int8, chunk = FULL_MODES[mode]
    spec = 1
    if rows == 8 and mode != "chunk":
        spec = 8 if mode == "bounded" else 2
    streams = rows // spec
    offs = FULL_OFFS["ring" if mode == "int8" else mode][:streams]
    if mode == "bounded" and spec > 1:
        offs = [S - spec]
    g = torch.Generator(device=dev).manual_seed(11 * rows + len(mode))
    shape = (streams, FULL_NKV_L, S, FULL_HD)
    kc = (torch.randn(shape, device=dev, generator=g) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=g) * 0.5).bfloat16()
    scales = (None, None)
    if int8:
        (kc, ks), (vc, vs) = tdsp.quantize_kv(kc), tdsp.quantize_kv(vc)
        scales = (ks, vs)
    x = torch.randn((rows, FULL_D), device=dev, generator=g)
    if rows == 1:
        off = offs[0]
        c, s = tdsp.rope_pair_vectors(off, FULL_HD, device=dev)
    else:
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        c, s = tdsp.rope_pair_vectors(
            (off[:, None] + torch.arange(spec, device=dev)).reshape(-1),
            FULL_HD)
    args = (x, FULL_LAYER, off, w["attn_norm"], w["sqkv"], w["so"], c, s, kc, vc, w["wqkv"], w["wo"], *scales)
    kw = dict(n_heads_l=FULL_NH_L, n_kv_l=FULL_NKV_L, head_dim=FULL_HD,
              eps=EPS, window=256, spec=spec, ring=ring, cache_chunk=chunk)
    return args, kw


def chain_equals_plain(call, ref, monkeypatch):
    """``call()`` bit-equal to ``ref`` as the chain of programmatic
    dependent launches on the chosen plans, then in plain stream order."""
    for pdl in (True, False):
        monkeypatch.setattr(ttp, "TP_PDL", pdl)
        got = call()
        torch.cuda.synchronize()
        _bit_equal(got, ref)


@pytest.fixture(scope="module")
def full_w8():
    return full_width_stacks("w8", _card())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(FULL_MODES))
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8])
def test_attn_half_step_full_width_on_card(full_w8, rows, mode, monkeypatch):
    """K4 at full width (w8), every row count a template takes, every
    cache mode, on the chosen plans (the one-row fused GEMV, the row
    route with one and two weight rows a warp, the tensor-core route,
    launches ahead or in order: test_tp_gemv_plan_reaches_every_route)
    as a chain and in plain stream order: bit for bit with the plain
    version, one launch counted a call."""
    args, kw = full_k4_case(full_w8, rows, mode, _card())
    ref = ttp.attn_half_step_plain(*args, **kw)
    before = ttp.attn_half_step.launches
    chain_equals_plain(lambda: ttp.attn_half_step(*args, **kw), ref,
                       monkeypatch)
    assert ttp.attn_half_step.launches == before + 2


def full_k5_args(w: dict, rows: int, dev):
    g = torch.Generator(device=dev).manual_seed(5 + rows)
    x = torch.randn((rows, FULL_D), device=dev, generator=g)
    return (x, FULL_LAYER, w["ffn_norm"], w["ada"], w["s13"], w["s2"],
            w["w13"], w["w2"])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8])
def test_ffn_half_step_full_width_on_card(full_w8, rows, monkeypatch):
    """K5 at full width (w8) and every row count a template takes, on the
    chosen plans as a chain and in plain stream order: bit for bit with
    the plain version."""
    args = full_k5_args(full_w8, rows, _card())
    ref = [ttp.ffn_half_step_plain(*args, eps=EPS)]
    chain_equals_plain(lambda: [ttp.ffn_half_step(*args, eps=EPS)], ref,
                       monkeypatch)
