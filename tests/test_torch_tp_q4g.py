"""q4g (exact Q4_0) decode on a mesh: the g32 halves of K4, K5 and K6,
K1 mode (i) over a g32 table, and the q4g model, sessions, pools and CLI
at tp = 2, dp = 2 and 2 x 2, against the JAX package.

Inputs mirror JAX's ``tests/test_tp_q4g.py``: the stacks of
``tests/test_q4g_stack.py`` (3 layers, D 256, 8 query / 2 KV heads of
32, hidden 512; codes in [-3, 3], f16 group scales, non-uniform where
the layout is the point) with bf16 caches, tp = 2, and the model config
``_tp_cfg()`` (nq / tp = hidden / tp = 128, the smallest widths JAX's
g32 gate takes).  The JAX side runs its Pallas halves in interpret mode
on the 8-device virtual CPU mesh (``tests/conftest.py``); the port runs
its plain versions on ``["cpu"] * 2`` (and ``* 4``).

Tolerances (those of ``tests/test_torch_tp.py``): the sharded weights
equal JAX's by value, exactly (the layouts differ: the port keeps K1
mode (h)'s [L, N, K] codes and [L, N, K/32] f16 scales); the partials,
x_out and K6's maximum within 1e-5 of the largest value (JAX sums the
g32 groups in f32, the port in f64 rounded once); k_new / v_new within
one bf16 ulp, bit-equal over an int8 cache; indices and tokens equal.
With uniform group scales the port's g32 TP step equals its w8 TP step
on the same effective weights within 1e-5 (JAX's equivalence).

The ``cuda`` tests hold each g32 kernel mode against its plain version
on the card, bit for bit; they skip here.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tests.test_q4g_stack as tq
from tests.test_torch_decode_step import (
    D, EPS, HEAD_DIM, HIDDEN, KV_RTOL, L, N_HEADS, N_KV, S, X_RTOL,
    params_from_numpy, to_torch,
)
from tests.test_torch_gguf import gguf_file  # noqa: F401  (a fixture)
from tests.test_torch_model import dense_params, test_mel
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_tp import (
    EPS as FULL_EPS, FULL_MODES, NH_L, NKV_L, TP, _close, _rope, _rows,
    chain_equals_plain, full_k4_case, full_k5_args, full_width_stacks,
)
from tests.test_tp_q4g import _tp_cfg
from voxtral_tpu.ops import decode_step_pallas as jdsp
from voxtral_tpu.ops import decode_tp_pallas as jtp
from voxtral_tpu.parallel import make_mesh as jax_make_mesh
from voxtral_tpu_torch.ops import decode_step as tdsp
from voxtral_tpu_torch.ops import decode_tp as ttp
from voxtral_tpu_torch.parallel import make_mesh

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

V = 384  # the g32 table of JAX's lm-fold test: 192 rows per shard
NQ, NKV = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM
# (offsets, spec, window, ring, int8, chunk) of K4 against JAX's halves.
K4_CASES = {
    "bounded": ([9], 1, 6, None, False, None),
    "spec": ([5, 11], 2, None, None, False, None),
    "chunk": ([7, 16], 1, 8, None, False, 8),
    "int8": ([3, 12], 1, 8, None, True, None),
    "ring": ([20, 13], 1, 8, (4, 8), False, None),
}
# The model: seed, weight scale and final-norm gain of a q4g tree whose
# two rows decode to three tokens each, other in each row, with every
# top-2 margin of the single device and of tp = 2 above 0.4 (the port's
# single device gives JAX's tokens).  At seed 9 and scale 0.3 bf16
# rounding moves the logits by more than 1 and JAX's own routes part
# (test_seed9_scale03_parting_is_bf16_rounding_noise).
MODEL_SEED, MODEL_SCALE, MODEL_GAIN = 10, 0.12, 6.0
MIN_MARGIN = 0.1
SPEC_K = 4


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _table(rng, tie_rows=()):
    """A g32 table [V, D] (codes in [-8, 7], f16 scales, as JAX's lm-fold
    test) with rows ``tie_rows`` equal and dominant for a positive
    query (a planted tie)."""
    codes = rng.integers(-8, 8, size=(V, D), dtype=np.int8)
    scales = (0.005 + rng.random((V, D // 32)) * 0.03).astype(np.float16)
    for r in tie_rows:
        codes[r] = 7
        scales[r] = np.float16(0.5)
    return codes, scales


@pytest.fixture(scope="module")
def setup():
    """JAX's and the port's fused and TP stacks of a non-uniform-scale
    q4g tree with a g32 table, ADA vectors, caches and rows."""
    import ml_dtypes

    rng = np.random.default_rng(5)
    q4, _ = tq.build_params(
        rng, lambda l, n, g: 2.0 ** rng.integers(0, 3, size=(l, n, g)))
    codes, scales = _table(np.random.default_rng(7))
    q4["tok_embeddings"] = {"q4": {"codes": codes, "scales": scales}}
    q4["norm"] = (1.0 + rng.normal(size=(D,)) * 0.1).astype(np.float32)
    tree = _tree(q4)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jf = jdsp.fuse_decode_weights_q4g(jtree)
    jtg = jtp.tp_shard_fused_weights_q4g(jf, N_HEADS, N_KV, HEAD_DIM, HIDDEN,
                                         TP)
    jlm = jtp.tp_shard_lm_head_q4g(jf["lm_codes"], jf["lm_scale"], TP)
    t_embed = (rng.normal(size=(1, 1, D)) * 0.3).astype(np.float32)
    adav = np.asarray(jdsp.ada_vectors(jtree, jnp.asarray(t_embed)))
    tf = tdsp.fuse_decode_weights_q4g(params_from_numpy(tree))
    ttg = ttp.tp_shard_fused_weights_q4g(tf, N_HEADS, N_KV, HEAD_DIM, HIDDEN,
                                         TP)
    tlm = ttp.tp_shard_lm_head_q4g(tf["lm_codes"], tf["lm_scale"], TP)
    bf16 = np.dtype(ml_dtypes.bfloat16)
    shape = (L, 4, N_KV, S + 2, HEAD_DIM)  # 4 streams, a spec tail
    k = (rng.normal(size=shape) * 0.4).astype(bf16)
    v = (rng.normal(size=shape) * 0.4).astype(bf16)
    x = (rng.normal(size=(2, D)) * 0.5).astype(np.float32)
    return dict(tree=tree, jf=jf, jtg=jtg, jlm=jlm, adav=adav, tf=tf,
                ttg=ttg, tlm=tlm, k=k, v=v, x=x, codes=codes, scales=scales)


def _deq_jax(codes, scales):
    """JAX's g32 layout (codes [..., SB, N, 128], r-major scales
    [..., 4 SB, 1, N]) -> the effective weights [..., N, K] (JAX's own
    ``deq``, ``tests/test_tp_q4g.py:88-96``)."""
    c = np.asarray(codes, np.float32)
    *lead, sb, n, _ = c.shape
    c = np.swapaxes(c, -3, -2).reshape(*lead, n, sb, 4, 32)
    s = np.asarray(scales, np.float32).reshape(*lead, 4, sb, n)
    s = np.moveaxis(s, (-3, -2, -1), (-1, -2, -3))  # [..., N, SB, 4]
    return (c * s[..., None]).reshape(*lead, n, sb * 128)


def _deq_port(codes, scales):
    """The port's g32 layout (codes [..., N, K], f16 scales
    [..., N, K/32]) -> the effective weights [..., N, K]."""
    s = np.repeat(scales.float().numpy(), 32, axis=-1)
    return codes.float().numpy() * s


def test_tp_shard_q4g_equals_jax_by_value(setup):
    """Column-parallel qkv / w13 segments, row-parallel wo / w2 with
    their own scale columns, the vocab shards of the table: the port's
    shards dequantize to JAX's exactly, for non-uniform group scales."""
    jtg, ttg = setup["jtg"], setup["ttg"]
    pairs = (("wqkv", "sqkv"), ("wo", "so"), ("w13", "s13"), ("w2", "s2"))
    for i in range(TP):
        for c, s in pairs:
            got = _deq_port(ttg[c][i], ttg[s][i])
            np.testing.assert_array_equal(
                got, _deq_jax(jtg[c][i], jtg[s][i]), err_msg=f"{c}[{i}]")
            assert ttg[s][i].dtype == torch.float16
        np.testing.assert_array_equal(
            _deq_port(setup["tlm"]["codes"][i], setup["tlm"]["scale"][i]),
            _deq_jax(setup["jlm"]["codes"][i], setup["jlm"]["scale"][i]))
    assert ttg["so"].shape == (TP, L, D, NQ // TP // 32)
    assert ttg["s2"].shape == (TP, L, D, HIDDEN // TP // 32)


def test_tp_shard_q4g_gate_matches_jax(setup):
    """nq / tp = 64 (4 query heads of 32 at tp = 2): JAX's gate refuses
    the g32 halves, and so does the port's, naming the rule; the table
    needs tp | vocab."""
    with pytest.raises(ValueError, match="% 128"):
        jtp.tp_shard_fused_weights_q4g(setup["jf"], 4, N_KV, HEAD_DIM,
                                       HIDDEN, TP)
    with pytest.raises(ValueError, match=r"local contraction dims % 128 "
                       r"\(nq/tp=64"):
        ttp.tp_shard_fused_weights_q4g(setup["tf"], 4, N_KV, HEAD_DIM,
                                       HIDDEN, TP)
    with pytest.raises(ValueError, match="must divide vocab"):
        ttp.tp_shard_lm_head_q4g(setup["tf"]["lm_codes"],
                                 setup["tf"]["lm_scale"], 5)
    with pytest.raises(ValueError, match="% 128"):
        ttp.check_tp_q4g(4, N_KV, HEAD_DIM, HIDDEN, 2)


def _bf16(a):
    """numpy bf16 / int8 / f32 (or a jax array) as a torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return to_torch(a.astype(np.float32)).to(torch.bfloat16)
    return to_torch(a)


def _k4_case(setup, mode, shard=1, layer=1):
    """(JAX's outputs, the port's args and kwargs) of K4 in g32 on one
    shard."""
    offs, spec, window, ring, int8, chunk = K4_CASES[mode]
    jtg, ttg = setup["jtg"], setup["ttg"]
    cos, sin = _rope(offs, spec)
    x = _rows(setup["x"], len(offs) * spec)
    heads = slice(shard * NKV_L, (shard + 1) * NKV_L)
    kc = jnp.asarray(setup["k"][:, :len(offs), heads, :S])
    vc = jnp.asarray(setup["v"][:, :len(offs), heads, :S])
    scales = (None, None)
    if int8:
        (kc, ks), (vc, vs) = jdsp.quantize_kv(kc), jdsp.quantize_kv(vc)
        scales = (ks[layer], vs[layer])
    an = np.asarray(setup["jf"]["attn_norm"][layer])
    kw = dict(n_heads_l=NH_L, n_kv_l=NKV_L, head_dim=HEAD_DIM, eps=EPS,
              window=window, spec=spec, ring=ring, cache_chunk=chunk)
    jk, jv = (kc, vc) if chunk else (kc[layer], vc[layer])
    ref = jtp.attn_half_step(
        jnp.asarray(x), layer, jnp.asarray(offs, jnp.int32), jnp.asarray(an),
        jtg["sqkv"][shard], jtg["so"][shard], jnp.asarray(cos),
        jnp.asarray(sin), jk, jv, jtg["wqkv"][shard], jtg["wo"][shard],
        *scales, interpret=True, **kw)
    args = (to_torch(x), layer, torch.tensor(offs, dtype=torch.int32),
            to_torch(an), ttg["sqkv"][shard][layer], ttg["so"][shard][layer],
            to_torch(cos), to_torch(sin), _bf16(kc[layer]), _bf16(vc[layer]),
            ttg["wqkv"][shard], ttg["wo"][shard],
            *(None if t is None else _bf16(t) for t in scales))
    return ref, args, kw


@pytest.mark.parametrize("mode", list(K4_CASES))
def test_attn_half_step_g32_plain_matches_jax(setup, mode):
    ref, args, kw = _k4_case(setup, mode)
    got = ttp.attn_half_step(*args, **kw)
    rows = len(K4_CASES[mode][0]) * K4_CASES[mode][1]
    assert got[0].shape == (rows, D) and got[1].dtype == torch.bfloat16
    _close(got[0], ref[0], X_RTOL, "partial")
    if K4_CASES[mode][4]:  # int8 cache: the fresh rows bit-equal (JAX)
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(r.astype(jnp.float32)))
    else:
        _close(got[1], ref[1], KV_RTOL, "k_new")
        _close(got[2], ref[2], KV_RTOL, "v_new")


@pytest.mark.parametrize("rows", [1, 6])
def test_ffn_half_step_g32_plain_matches_jax(setup, rows):
    jtg, ttg, layer, shard = setup["jtg"], setup["ttg"], 2, 0
    x = _rows(setup["x"], rows)
    fn = np.asarray(setup["jf"]["ffn_norm"][layer])
    ada = setup["adav"][layer]
    ref = jtp.ffn_half_step(
        jnp.asarray(x), layer, jnp.asarray(fn), jnp.asarray(ada),
        jtg["s13"][shard], jtg["s2"][shard], jtg["w13"][shard],
        jtg["w2"][shard], eps=EPS, interpret=True)
    got = ttp.ffn_half_step(
        to_torch(x), layer, to_torch(fn), to_torch(ada),
        ttg["s13"][shard][layer], ttg["s2"][shard][layer],
        ttg["w13"][shard], ttg["w2"][shard], eps=EPS)
    assert got.shape == (rows, D) and got.dtype == torch.float32
    _close(got, ref, X_RTOL, "partial")


def _g32_table(tie_rows):
    """The port's table and JAX's g32 layout of it, with a planted tie."""
    codes, scales = _table(np.random.default_rng(7), tie_rows)
    return ((to_torch(codes), to_torch(scales)),
            (jdsp._g32_codes(codes), jdsp._g32_scales(scales)))


@pytest.mark.parametrize("rows", [1, 5, 8])
@pytest.mark.parametrize("ties,first", [((), None), ((100, 300), (100, 108))])
def test_lm_half_argmax_g32_plain_matches_jax(setup, rows, ties, first):
    """Per shard: the maximum within 1e-5, the first local index equal,
    over g32 shards; (100, 300) plants a tie across the shards (local
    rows 100 of shard 0 and 108 of shard 1)."""
    (tc, ts), (jc, js) = _g32_table(ties)
    x = np.abs(_rows(setup["x"], rows))
    fnorm = np.abs(setup["tree"]["norm"])
    vl = V // TP
    for shard in range(TP):
        part = slice(shard * vl, (shard + 1) * vl)
        jv, ji = jtp.lm_half_argmax(
            jnp.asarray(x), jnp.asarray(fnorm), js[:, :, part], jc[:, part],
            eps=EPS, interpret=True)
        tv, ti = ttp.lm_half_argmax(to_torch(x), to_torch(fnorm), ts[part],
                                    tc[part], eps=EPS)
        _close(tv, jv, X_RTOL, f"max of shard {shard}")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if first is not None:
            assert ti.ravel().tolist() == [first[shard]] * rows


def _step_inputs(setup, offs, spec):
    x = _rows(setup["x"], len(offs) * spec)
    cos, sin = _rope(offs, spec)
    n = len(offs)
    return x, cos, sin, setup["k"][:, :n], setup["v"][:, :n]


def _shard_cache(cache, n_data):
    per, kl = cache.shape[1] // n_data, N_KV // TP
    return [[cache[:, d * per:(d + 1) * per, i * kl:(i + 1) * kl]
             .contiguous() for i in range(TP)] for d in range(n_data)]


def _port_step(setup, mesh, n_data, stacks, x, offs, cos, sin, kc, vc, kw,
               fused=None):
    fused = fused or setup["tf"]
    return ttp.tp_decode_step(
        mesh, to_torch(x), torch.tensor(offs, dtype=torch.int32),
        fused["attn_norm"], fused["ffn_norm"], to_torch(setup["adav"]),
        ttp.place_shards(mesh, stacks), to_torch(cos), to_torch(sin),
        _shard_cache(_bf16(kc), n_data), _shard_cache(_bf16(vc), n_data),
        **kw)


def test_g32_tp_step_equals_w8_tp_step_on_uniform_scales(setup):
    """JAX's equivalence (``tests/test_tp_q4g.py:123``): with uniform
    group scales the g32 halves compute the w8 halves' weights, so the
    port's g32 TP step equals its w8 TP step within 1e-5, every layer,
    sequential and spec = 2."""
    q4, w8 = tq.build_params(np.random.default_rng(11),
                             lambda l, n, g: np.ones((l, n, g)))
    tg = tdsp.fuse_decode_weights_q4g(params_from_numpy(_tree(q4)))
    tw = tdsp.fuse_decode_weights(params_from_numpy(_tree(w8)))
    sg = ttp.tp_shard_fused_weights_q4g(tg, N_HEADS, N_KV, HEAD_DIM, HIDDEN,
                                        TP)
    sw = ttp.tp_shard_fused_weights(tw, N_HEADS, N_KV, HEAD_DIM, HIDDEN, TP)
    mesh = make_mesh(1, TP, ["cpu"] * TP)
    for offs, spec in (([9, 4], 1), ([5, 11], 2)):
        ins = _step_inputs(setup, offs, spec)
        kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
                  window=6, spec=spec)
        gx, gk, gv = _port_step(setup, mesh, 1, sg, ins[0], offs, *ins[1:],
                                kw, tg)
        wx, wk, wv = _port_step(setup, mesh, 1, sw, ins[0], offs, *ins[1:],
                                kw, tw)
        _close(gx, wx.numpy(), X_RTOL, "x_out")
        _close(ttp.gather_kv(gk), ttp.gather_kv(wk).float().numpy(), X_RTOL,
               "k_new")
        _close(ttp.gather_kv(gv), ttp.gather_kv(wv).float().numpy(), X_RTOL,
               "v_new")


@requires_8_devices
@pytest.mark.parametrize("n_data,offs,spec", [
    (1, [5, 11], 2),
    (2, [5, 11, 3, 14], 1),   # 2 x 2: the streams split over data
])
def test_tp_decode_step_and_token_g32_match_jax(setup, n_data, offs, spec):
    """``tp_decode_step`` and ``tp_lm_head_token`` over g32 shards against
    JAX's ``shard_map``; the token equals the argmax of JAX's
    ``q4g_matmul_a8`` logits of the final-norm output (``tests/
    test_tp_q4g.py:210-245``)."""
    from voxtral_tpu.ops.q4 import q4g_matmul_a8

    x, cos, sin, kc, vc = _step_inputs(setup, offs, spec)
    jf = setup["jf"]
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=6, spec=spec)
    jmesh = jax_make_mesh(n_data, TP)
    da = "data" if n_data > 1 else None
    jx, jk, jv = jtp.tp_decode_step(
        jmesh, jnp.asarray(x), jnp.asarray(offs, jnp.int32), jf["attn_norm"],
        jf["ffn_norm"], jnp.asarray(setup["adav"]), setup["jtg"],
        jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kc), jnp.asarray(vc),
        interpret=True, data_axis=da, **kw)
    fnorm = setup["tree"]["norm"]
    jtok = jtp.tp_lm_head_token(jmesh, jx, jnp.asarray(fnorm),
                                setup["jlm"]["codes"], setup["jlm"]["scale"],
                                eps=EPS, interpret=True, data_axis=da)
    mesh = make_mesh(n_data, TP, ["cpu"] * (n_data * TP))
    tx, tk, tv = _port_step(setup, mesh, n_data, setup["ttg"], x, offs, cos,
                            sin, kc, vc, kw)
    _close(tx, jx, X_RTOL, "x_out")
    _close(ttp.gather_kv(tk), jk, KV_RTOL, "k_new")
    _close(ttp.gather_kv(tv), jv, KV_RTOL, "v_new")
    tlm = ttp.place_shards(mesh, setup["tlm"])
    ttok = ttp.tp_lm_head_token(mesh, tx, to_torch(fnorm), tlm["codes"],
                                tlm["scale"], eps=EPS)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    xf = jnp.asarray(tx.numpy())
    h = xf * jax.lax.rsqrt(jnp.mean(xf * xf, -1, keepdims=True) + EPS) \
        * jnp.asarray(fnorm)
    logits = q4g_matmul_a8(h, jnp.asarray(setup["codes"]),
                           jnp.asarray(setup["scales"]))
    assert ttok.tolist() == np.argmax(np.asarray(logits), -1).tolist()


def _k1_args(setup, offs, spec, table):
    x, cos, sin, kc, vc = _step_inputs(setup, offs, spec)
    tf = setup["tf"]
    return (to_torch(np.abs(x)), torch.tensor(offs, dtype=torch.int32),
            tf["attn_norm"], tf["ffn_norm"], to_torch(setup["adav"]),
            tf["sqkv"], tf["so"], tf["s13"], tf["s2"], to_torch(cos),
            to_torch(sin), _bf16(kc), _bf16(vc), tf["wqkv"], tf["wo"],
            tf["w13"], tf["w2"], to_torch(np.abs(setup["tree"]["norm"])),
            *table)


@pytest.mark.parametrize("offs,spec", [([9], 1), ([5, 11], 3)])
def test_k1_lm_argmax_g32_plain_matches_jax(setup, offs, spec):
    """K1 mode (i) over a g32 table (a tie planted across the tiles):
    tokens equal JAX's ``decode_stack_step(lm_argmax=True)`` on its g32
    stacks, and the argmax of mode (h)'s logits."""
    (tc, ts), (jc, js) = _g32_table((40, 300))
    args = _k1_args(setup, offs, spec, (tc, ts))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=6, spec=spec)
    jf = setup["jf"]
    j = [jnp.asarray(a.float().numpy() if a.dtype == torch.bfloat16
                     else a.numpy()) if isinstance(a, torch.Tensor) else a
         for a in args[:13]]
    j[11], j[12] = j[11].astype(jnp.bfloat16), j[12].astype(jnp.bfloat16)
    ref = jdsp.decode_stack_step(
        *j[:5], jf["sqkv"], jf["so"], jf["s13"], jf["s2"], *j[9:13],
        jf["wqkv"], jf["wo"], jf["w13"], jf["w2"],
        final_norm=jnp.asarray(args[17].numpy()), lm_codes=jc, lm_scale=js,
        interpret=True, lm_argmax=True, **kw)
    got = tdsp.decode_stack_step(*args, lm_argmax=True, **kw)
    assert got[3].dtype == torch.int32 and got[3].shape == (len(offs) * spec,
                                                            1)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    logits = tdsp.decode_stack_step(*args, **kw)[3]
    assert got[3][:, 0].tolist() == logits.argmax(-1).tolist()


def test_wrappers_on_cpu_count_no_launch(setup):
    names = ("launches", "g32_launches")
    fns = (ttp.attn_half_step, ttp.ffn_half_step, ttp.lm_half_argmax)
    before = [getattr(f, n) for f in fns for n in names]
    _, args, kw = _k4_case(setup, "bounded")
    assert all(torch.equal(g, r) for g, r in zip(
        ttp.attn_half_step(*args, **kw),
        ttp.attn_half_step_plain(*args, **kw)))
    assert [getattr(f, n) for f in fns for n in names] == before
    assert tdsp.decode_stack_step.argmax_g32_launches == 0


# ---------------------------------------------------------------------------
# The model, sessions, pools and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_setup():
    """``_tp_cfg()``'s q4g tree (unpacked Q4_0 of a dense random tree),
    two mel rows and the port's single-device model."""
    from voxtral_tpu.utils.quantize import quantize_params_q4
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg = _tp_cfg()
    dense = dense_params(cfg, MODEL_SEED, MODEL_SCALE, MODEL_GAIN)
    tree = quantize_params_q4(dense, to_device=False, pack=False)
    mel = test_mel()
    single = VoxtralModel.from_numpy(tree, cfg, "cpu")
    assert single.decode_route == "q4g"
    return cfg, tree, np.concatenate([mel, mel * 0.8]), single


MESHES = [(1, 2), (2, 1), (2, 2)]  # (data, model)


def test_seed9_scale03_parting_is_bf16_rounding_noise(monkeypatch):
    """Seed 9, weight scale 0.3 of ``_tp_cfg()`` (one row of
    ``test_mel()``), where the residual stream reaches about 50 and the
    logits about 100: the port's single-device q4g parts from JAX's at a
    top-2 margin above 1 (1.3 % of the largest logit).  That is the size
    of bf16 rounding there, not a fault of the port: JAX's own two
    routes for the bf16 cast of the same tree (the XLA step and the
    stack kernel) part at a margin at least as large, where the port
    gives the stack kernel's tokens; on the f32 tree the port gives
    JAX's tokens."""
    import ml_dtypes

    import voxtral_tpu_torch.models.voxtral as tv
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.utils.quantize import quantize_params_q4
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, mel = _tp_cfg(), test_mel()
    dense = dense_params(cfg, 9, 0.3, MODEL_GAIN)
    trees = {"f32": dense,
             "bf16": jax.tree_util.tree_map(
                 lambda a: a.astype(ml_dtypes.bfloat16)
                 if a.dtype == np.float32 else a, dense),
             "q4g": quantize_params_q4(dense, to_device=False, pack=False)}
    top = []
    margin_of = tv.top2_margin

    def spy(logits):
        top.append(float(logits.float().max()))
        return margin_of(logits)

    monkeypatch.setattr(tv, "top2_margin", spy)

    def port(name):
        model = VoxtralModel.from_numpy(trees[name], cfg, "cpu")
        model.record_margins = True
        return (model.transcribe_streaming_batch(mel)[0],
                model.last_margins[0])

    def jax_route(name, route):
        monkeypatch.setenv("VOXTRAL_MEGAKERNEL", route)
        model = JaxModel(jax.tree_util.tree_map(jnp.asarray, trees[name]),
                         cfg)
        return np.asarray(model.transcribe_streaming_batch(mel))[0]

    def parting(a, b):
        same = a == b
        assert not same.all()
        return int(np.argmin(same))

    f32, _ = port("f32")
    assert f32.tolist() == jax_route("f32", "0").tolist()
    top.clear()
    q4g, q4g_margins = port("q4g")
    i = parting(q4g, jax_route("q4g", "0"))
    assert 1.0 < q4g_margins[i] < 0.02 * max(top)
    bf16, bf16_margins = port("bf16")
    stack = jax_route("bf16", "force")
    assert bf16.tolist() == stack.tolist()
    j = parting(jax_route("bf16", "0"), stack)
    assert bf16_margins[j] >= q4g_margins[i]


@pytest.fixture(scope="module")
def models(model_setup):
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree = model_setup[:2]
    return {m: VoxtralModel.from_numpy(
        tree, cfg, mesh=make_mesh(*m, ["cpu"] * (m[0] * m[1])))
        for m in MESHES}


@pytest.fixture(scope="module")
def jax_tokens(model_setup):
    """JAX's meshed q4g transcribe of the two rows ({(data, model):
    tokens}), its g32 halves and stack kernel in interpret mode."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, tree, mel2, _ = model_setup
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        for nd, nm in MESHES:
            m = JaxModel(jtree, cfg, mesh=jax_make_mesh(nd, nm))
            assert m.megakernel_weights == "q4g"
            out[(nd, nm)] = np.asarray(m.transcribe_streaming_batch(mel2))
    return out


def test_q4g_meshed_model_layout(model_setup, models):
    """The placed g32 grids: [d][i] per shard, f16 scale shards of their
    own K/32 columns, the g32 table's vocab shards; dp keeps K1's g32
    stacks and table per data group."""
    cfg = model_setup[0]
    lm = cfg.language_model
    tp = models[(1, 2)]
    assert tp.fused_decode is None and tp.decode_route == "q4g"
    grid = tp.fused_tp["wqkv"]
    assert len(grid) == 1 and len(grid[0]) == 2
    nq_l = lm.n_heads * lm.head_dim // 2
    assert tp.fused_tp["so"][0][1].shape == (lm.n_layers, lm.dim, nq_l // 32)
    assert tp.fused_tp["so"][0][1].dtype == torch.float16
    assert tp.fused_tp["lm_codes"][0][1].shape == (lm.vocab_size // 2, lm.dim)
    assert tp.fused_tp["lm_scale"][0][1].shape == (lm.vocab_size // 2,
                                                   lm.dim // 32)
    assert len(models[(2, 2)].fused_tp["w2"]) == 2
    # A shard's admission counts its f16 scale shards at their own size.
    from voxtral_tpu_torch.utils.hbm import shard_weight_bytes

    assert shard_weight_bytes(tp, 0, 1) == sum(
        g[0][1].numel() * g[0][1].element_size()
        for g in tp.fused_tp.values())
    dp = models[(2, 1)]
    assert dp.fused_tp is None and len(dp._dp_stacks["lm_scale"]) == 2
    assert dp._dp_stacks["lm_scale"][1].dtype == torch.float16
    assert dp._dp_stacks["sqkv"][0].dim() == 3


@requires_8_devices
@pytest.mark.parametrize("nd,nm", MESHES)
def test_q4g_meshed_tokens_match_jax(model_setup, models, jax_tokens, nd,
                                     nm):
    """The two rows on each mesh: tokens equal JAX's meshed q4g
    transcribe, every top-2 margin above MIN_MARGIN; speculative K = 4
    equals sequential; dp equals the single device exactly."""
    mel2, single = model_setup[2], model_setup[3]
    model = models[(nd, nm)]
    model.record_margins = True
    try:
        seq = model.transcribe_streaming_batch(mel2)
        assert float(model.last_margins.min()) > MIN_MARGIN
    finally:
        model.record_margins = False
    assert model.last_decode_route == ("tp" if nm > 1 else "dp")
    assert len(set(seq[0].tolist())) > 1 and seq[0].tolist() != seq[1].tolist()
    assert seq.tolist() == jax_tokens[(nd, nm)].tolist()
    spec = model.transcribe_streaming_batch(mel2, speculative=SPEC_K)
    assert 0 < model.last_spec_passes < seq.shape[1]
    assert spec.tolist() == seq.tolist()
    if nm == 1:
        assert seq.tolist() == single.transcribe_streaming_batch(
            mel2).tolist()


def test_spec_pass_through_the_cache_is_sequential(model_setup, models):
    """The witness ``chip_smoke.py`` holds a q4g tp = 2 speculative run
    to before it lets one part from sequential above the spec near-tie
    (``chip_smoke.spec_held``): a speculative pass reads its earlier
    fresh rows in f32, the sequential step reads them back from the bf16
    cache.  At tp = 2 the pass's top-2 margins differ from sequential by
    more than 1e-2; with ``chip_smoke.fresh_through_cache`` (the pass's
    rows one at a time, the earlier ones through the cache) they are
    sequential's within 1e-5."""
    import chip_smoke

    mel2 = model_setup[2]
    model = models[(1, 2)]
    runs = []
    attn = ttp._attention_plain
    model.record_margins = True
    try:
        for spec, through in ((0, False), (SPEC_K, False), (SPEC_K, True)):
            if through:
                ttp._attention_plain = chip_smoke.fresh_through_cache(attn)
            tokens = model.transcribe_streaming_batch(mel2, speculative=spec)
            runs.append((tokens.tolist(), model.last_margins.copy()))
    finally:
        ttp._attention_plain = attn
        model.record_margins = False
    (seq, seq_m), (spec, spec_m), (through, through_m) = runs
    assert spec == seq and through == seq
    assert np.abs(spec_m - seq_m).max() > 1e-2
    assert np.abs(through_m - seq_m).max() < 1e-5


def test_q4g_mesh_gate_and_refusals(model_setup):
    """JAX's ``test_tp_q4g_gate_falls_back`` config (nq / tp = 64) rides
    JAX's GSPMD step; the port raises, naming the rule and ROADMAP item
    12.3.  On a dp mesh (no TP halves, so no gate) the same model takes
    K1's g32 stacks per data group."""
    from scripts.q4_error_report import error_cfg
    from voxtral_tpu.utils.quantize import quantize_params_q4
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg = error_cfg()
    tree = quantize_params_q4(dense_params(cfg, 1, 0.1), to_device=False,
                              pack=False)
    with pytest.raises(ValueError, match=r"% 128 .*nq/tp=64.*12\.3"):
        VoxtralModel.from_numpy(tree, cfg, mesh=make_mesh(1, 2, ["cpu"] * 2))
    assert VoxtralModel.from_numpy(
        tree, cfg, mesh=make_mesh(2, 1, ["cpu"] * 2))._dp_stacks is not None


@pytest.fixture(scope="module")
def pool_setup():
    """JAX's own inputs of ``test_tp_q4g_pooled_streaming_matches_solo``:
    ``init_random(PRNGKey(4))`` on ``_tp_cfg()`` quantized to unpacked
    Q4_0, the audio of ``default_rng(8)``; the port's models on one
    device and on each mesh."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.utils.quantize import quantize_params_q4
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg = _tp_cfg()
    dense = JaxModel.init_random(jax.random.PRNGKey(4), cfg,
                                 dtype=np.float32).params
    tree = _tree(quantize_params_q4(_tree(dense), to_device=False,
                                    pack=False))
    rng = np.random.default_rng(8)
    audio = (rng.normal(size=16000 * 3).astype(np.float32) * 0.25,
             rng.normal(size=16000 * 2).astype(np.float32) * 0.3)
    models = {m: VoxtralModel.from_numpy(
        tree, cfg, mesh=make_mesh(*m, ["cpu"] * (m[0] * m[1])))
        for m in MESHES}
    models[(1, 1)] = VoxtralModel.from_numpy(tree, cfg, "cpu")
    return cfg, tree, audio, models


def _pooled(model, audio):
    """Two streams of one pool fed in halves -> (pool, their tokens)."""
    from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

    pool = StreamPool(model, max_streams=2, step_positions=8,
                      max_duration_s=30)
    pa = StreamingSession(model, step_positions=8, pool=pool)
    pb = StreamingSession(model, step_positions=8, pool=pool)
    for qa, qb in zip(*(np.array_split(a, 2) for a in audio)):
        pa.feed(qa)
        pb.feed(qb)
    pa.finish()
    pb.finish()
    return pool, [pa.tokens, pb.tokens]


@requires_8_devices
def test_q4g_pooled_streaming_matches_solo_and_jax(pool_setup):
    """JAX's ``test_tp_q4g_pooled_streaming_matches_solo`` on the port, on
    its inputs: a tp = 2 pool of two q4g streams rides the g32 halves and
    K6's g32 fold, and its tokens equal the solo tp = 2 sessions', which
    equal JAX's solo tp = 2 sessions'.  A 2 x 2 pool equals the tp = 2
    pool and a dp = 2 pool the single device's pool exactly."""
    import voxtral_tpu.streaming as jstreaming
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu_torch.streaming import StreamingSession

    cfg, tree, audio, models = pool_setup

    def solo(Session, m, a):
        s = Session(m, step_positions=8, max_duration_s=30)
        s.feed(a)
        s.finish()
        return s.tokens

    tp = models[(1, 2)]
    want = [solo(StreamingSession, tp, a) for a in audio]
    pool, got = _pooled(tp, audio)
    assert pool._fused is not None and pool._tp_mesh is not None
    assert got == want
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        jm = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg,
                      mesh=jax_make_mesh(1, 2))
    assert [solo(jstreaming.StreamingSession, jm, a) for a in audio] == want
    assert _pooled(models[(2, 2)], audio)[1] == got
    dp_pool, dp_got = _pooled(models[(2, 1)], audio)
    assert dp_pool._dp_mesh is not None
    assert dp_got == _pooled(models[(1, 1)], audio)[1]


@requires_8_devices
def test_q4g_mixed_table_meshes_match_jax(model_setup, pool_setup):
    """A q4g stack over a table that is not g32 (the dense f32 table of
    the pooled test's ``init_random(PRNGKey(4))`` tree) has no fold: the
    tp and dp meshes take the whole lm_head on the first device (no K6
    or K1 (i) launch).  One-shot at tp = 2 and dp = 2: tokens equal JAX's
    meshed transcribe of the same tree and the single device's.  Streams:
    a tp = 2 pool equals the solo tp = 2 sessions, which equal JAX's; a
    dp = 2 pool equals the single device's pool."""
    import voxtral_tpu.streaming as jstreaming
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.streaming import StreamingSession

    cfg, tree, audio, _ = pool_setup
    mel2 = model_setup[2]
    table = JaxModel.init_random(jax.random.PRNGKey(4), cfg,
                                 dtype=np.float32).params["decoder"][
                                     "tok_embeddings"]
    mixed = dict(tree, decoder=dict(tree["decoder"],
                                    tok_embeddings=np.asarray(table)))
    one = VoxtralModel.from_numpy(mixed, cfg, "cpu")
    assert one.decode_route == "q4g" and "lm_codes" not in one.fused_decode
    models = {m: VoxtralModel.from_numpy(mixed, cfg,
                                         mesh=make_mesh(*m, ["cpu"] * 2))
              for m in ((1, 2), (2, 1))}
    jtree = jax.tree_util.tree_map(jnp.asarray, mixed)
    want = one.transcribe_streaming_batch(mel2).tolist()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        jms = {m: JaxModel(jtree, cfg, mesh=jax_make_mesh(*m))
               for m in models}
    for m, model in models.items():
        assert "lm_codes" not in (model.fused_tp or model._dp_stacks)
        got = model.transcribe_streaming_batch(mel2).tolist()
        assert got == want
        assert got == np.asarray(jms[m].transcribe_streaming_batch(
            mel2)).tolist()

    def solo(Session, m, a):
        s = Session(m, step_positions=8, max_duration_s=30)
        s.feed(a)
        s.finish()
        return s.tokens

    tp = models[(1, 2)]
    solo_tp = [solo(StreamingSession, tp, a) for a in audio]
    assert solo_tp == [solo(jstreaming.StreamingSession, jms[(1, 2)], a)
                       for a in audio]
    pool, got = _pooled(tp, audio)
    assert pool._tp_mesh is not None and got == solo_tp
    dp_pool, dp_got = _pooled(models[(2, 1)], audio)
    assert dp_pool._dp_mesh is not None
    assert dp_got == _pooled(one, audio)[1]


def test_q4g_meshed_checkpoint_restores_on_one_device(pool_setup):
    """A slot of a 2 x 2 q4g pool snapshots to the solo layout and
    restores into a single-device q4g session, which continues as the
    restore of the same slot from a single-device pool does."""
    from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

    _, _, (audio, other), models = pool_setup
    single = models[(1, 1)]

    def pooled_state(model):
        pool = StreamPool(model, max_streams=2, step_positions=8,
                          max_duration_s=30)
        pa = StreamingSession(model, step_positions=8, pool=pool)
        pb = StreamingSession(model, step_positions=8, pool=pool)
        pa.feed(audio[:30000])
        pb.feed(other)
        assert pa.positions_done > 0
        return pa.state_dict()

    def continued(state):
        s = StreamingSession.restore(single, state)
        s.feed(audio[30000:])
        s.finish()
        return s.tokens

    state = pooled_state(models[(2, 2)])
    assert state["dec_k"].shape[3] == single.config.language_model.n_kv_heads
    assert continued(state) == continued(pooled_state(single))


def test_g32_tp_step_is_the_single_step_with_tp_quant_groups(setup):
    """The second witness ``chip_smoke.py`` holds a q4g tp = 2 run to
    when it parts from the single card before a decoded token agrees:
    K1's plain step with ``chip_smoke.tp_quant_groups`` over g32 (the WO
    and W2 inputs quantized per shard, each shard's own group-scale
    columns, the partials summed in shard order) is the g32 TP step's
    arithmetic: x_out and k_new / v_new bit-equal over three layers,
    where the step as it is differs."""
    from types import SimpleNamespace

    import chip_smoke

    offs, spec = [5, 11], 2
    x, cos, sin, kc, vc = _step_inputs(setup, offs, spec)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=6, spec=spec)
    mesh = make_mesh(1, TP, ["cpu"] * TP)
    tx, tk, tv = _port_step(setup, mesh, 1, setup["ttg"], x, offs, cos, sin,
                            kc, vc, kw)
    tf = setup["tf"]
    args = (to_torch(x), torch.tensor(offs, dtype=torch.int32),
            tf["attn_norm"], tf["ffn_norm"], to_torch(setup["adav"]),
            tf["sqkv"], tf["so"], tf["s13"], tf["s2"], to_torch(cos),
            to_torch(sin), _bf16(kc), _bf16(vc), tf["wqkv"], tf["wo"],
            tf["w13"], tf["w2"])
    single = tdsp.decode_stack_step_plain(*args, **kw)
    model = SimpleNamespace(config=SimpleNamespace(
        language_model=SimpleNamespace(dim=D)))
    restore = chip_smoke.tp_quant_groups(model, TP)
    try:
        grouped = tdsp.decode_stack_step_plain(*args, **kw)
    finally:
        restore()
    assert torch.equal(grouped[0], tx)
    assert torch.equal(grouped[1], ttp.gather_kv(tk))
    assert torch.equal(grouped[2], ttp.gather_kv(tv))
    assert not torch.equal(single[0], tx)


def test_cli_q4g_tp_dp_on_cpu(gguf_file, capsys):
    """``--gguf --weight-format q4g`` with ``--tp 2`` and ``--dp 2`` on
    ``--device cpu``: the line of the run without a mesh."""
    from voxtral_tpu_torch import cli
    from voxtral_tpu_torch.audio import AudioBuffer, save_wav

    cfg, path = gguf_file
    sr = 16000
    t = np.arange(int(1.5 * sr)) / sr
    wav = path.parent / "tone_q4g_mesh.wav"
    save_wav(AudioBuffer((0.4 * np.sin(2 * np.pi * 440 * t)).astype(
        np.float32), sr), wav)
    params = path.parent / "params_q4g_mesh.json"
    params.write_text(cfg.to_params_json())
    base = ["--gguf", str(path), "--tokenizer",
            str(path.parent / "tekken.json"), "--params", str(params),
            "--weight-format", "q4g", "--device", "cpu", "--audio",
            str(wav)]
    outs = {}
    for extra in ([], ["--tp", "2"], ["--dp", "2"]):
        assert cli.main(base + extra) == 0, extra
        outs[tuple(extra)] = capsys.readouterr().out
    assert len(outs[()].splitlines()) == 1
    assert outs[("--tp", "2")] == outs[()] == outs[("--dp", "2")]


# ---------------------------------------------------------------------------
# On the card: each g32 kernel mode against its plain version, bit for bit
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
        assert torch.equal(g, r), (g.float() - r.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(K4_CASES))
def test_attn_half_step_g32_kernel_matches_plain_on_card(setup, mode):
    dev = _card()
    _, args, kw = _k4_case(setup, mode)
    args = _to(args, dev)
    before = ttp.attn_half_step.g32_launches
    got = ttp.attn_half_step(*args, **kw)
    torch.cuda.synchronize()
    assert ttp.attn_half_step.g32_launches == before + 1
    _bit_equal(got, ttp.attn_half_step_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 12])
def test_ffn_half_step_g32_kernel_matches_plain_on_card(setup, rows):
    dev = _card()
    ttg, layer = setup["ttg"], 0
    args = _to((to_torch(_rows(setup["x"], rows)), layer,
                setup["tf"]["ffn_norm"][layer],
                to_torch(setup["adav"][layer]), ttg["s13"][1][layer],
                ttg["s2"][1][layer], ttg["w13"][1], ttg["w2"][1]), dev)
    before = ttp.ffn_half_step.g32_launches
    got = ttp.ffn_half_step(*args, eps=EPS)
    torch.cuda.synchronize()
    assert ttp.ffn_half_step.g32_launches == before + 1
    _bit_equal([got], [ttp.ffn_half_step_plain(*args, eps=EPS)])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 11])
@pytest.mark.parametrize("ties", [(), (100, 150)])
def test_lm_half_argmax_g32_kernel_matches_plain_on_card(setup, rows, ties):
    dev = _card()
    (tc, ts), _ = _g32_table(ties)
    vl = V // TP
    args = _to((to_torch(np.abs(_rows(setup["x"], rows))),
                to_torch(np.abs(setup["tree"]["norm"])), ts[:vl], tc[:vl]),
               dev)
    before = ttp.lm_half_argmax.g32_launches
    got = ttp.lm_half_argmax(*args, eps=EPS)
    torch.cuda.synchronize()
    assert ttp.lm_half_argmax.g32_launches == before + 1
    _bit_equal(got, ttp.lm_half_argmax_plain(*args, eps=EPS))
    if ties:
        assert got[1].ravel().tolist() == [100] * rows


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec", [([9], 1), ([5, 11], 3),
                                       ([1, 4, 6, 9], 2)])
def test_k1_lm_argmax_g32_kernel_matches_plain_on_card(setup, offs, spec):
    dev = _card()
    (tc, ts), _ = _g32_table((40, 300))
    args = _to(_k1_args(setup, offs, spec, (tc, ts)), dev)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=6, spec=spec)
    before = tdsp.decode_stack_step.argmax_g32_launches
    got = tdsp.decode_stack_step(*args, lm_argmax=True, **kw)
    torch.cuda.synchronize()
    assert tdsp.decode_stack_step.argmax_g32_launches == before + 1
    _bit_equal(got, tdsp.decode_stack_step_plain(*args, lm_argmax=True,
                                                 **kw))
    logits = tdsp.decode_stack_step(*args, **kw)[3]
    assert got[3][:, 0].tolist() == logits.argmax(-1).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("nd,nm", MESHES)
def test_q4g_meshed_kernels_match_plain_on_card(model_setup, nd, nm):
    """On one card (the shards share it): the g32 kernels' tokens equal
    the plain versions' on every mesh, sequential and speculative; dp
    equals the single card's batch exactly."""
    dev = _card()
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree, mel2, _ = model_setup
    mesh = make_mesh(nd, nm, [dev] * (nd * nm))
    got = VoxtralModel.from_numpy(tree, cfg, mesh=mesh)
    plain = VoxtralModel.from_numpy(tree, cfg, mesh=mesh, kernels=False)
    g32 = (ttp.attn_half_step.g32_launches,
           tdsp.decode_stack_step.argmax_g32_launches)
    seq = got.transcribe_streaming_batch(mel2)
    assert (ttp.attn_half_step.g32_launches,
            tdsp.decode_stack_step.argmax_g32_launches) != g32
    assert seq.tolist() == plain.transcribe_streaming_batch(mel2).tolist()
    assert got.transcribe_streaming_batch(
        mel2, speculative=SPEC_K).tolist() == seq.tolist()
    if nm == 1:
        one = VoxtralModel.from_numpy(tree, cfg, dev)
        assert one.transcribe_streaming_batch(mel2).tolist() == seq.tolist()


@pytest.fixture(scope="module")
def full_g32():
    return full_width_stacks("g32", _card())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(FULL_MODES))
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8])
def test_attn_half_step_g32_full_width_on_card(full_g32, rows, mode,
                                               monkeypatch):
    """K4 over g32 weights at full width, every row count a template
    takes, every cache mode, on the chosen plans as a chain and in plain
    stream order: bit for bit with the plain version, each call a g32
    launch."""
    args, kw = full_k4_case(full_g32, rows, mode, _card())
    ref = ttp.attn_half_step_plain(*args, **kw)
    before = ttp.attn_half_step.g32_launches
    chain_equals_plain(lambda: ttp.attn_half_step(*args, **kw), ref,
                       monkeypatch)
    assert ttp.attn_half_step.g32_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8])
def test_ffn_half_step_g32_full_width_on_card(full_g32, rows, monkeypatch):
    """K5 over g32 weights at full width, every row count a template
    takes, on the chosen plans as a chain and in plain stream order: bit
    for bit."""
    args = full_k5_args(full_g32, rows, _card())
    ref = [ttp.ffn_half_step_plain(*args, eps=FULL_EPS)]
    chain_equals_plain(lambda: [ttp.ffn_half_step(*args, eps=FULL_EPS)],
                       ref, monkeypatch)
