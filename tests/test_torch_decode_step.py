"""K1: the port's decode stack step against the JAX stack kernel.

The same numpy inputs go through ``voxtral_tpu.ops.decode_step_pallas.
decode_stack_step`` (Pallas, interpret mode, lm fold to logits) and
``voxtral_tpu_torch.ops.decode_step.decode_stack_step`` (on the CPU: its
plain PyTorch version).  Production layout: bf16 head-major caches, w8
weights, sliding window; mode (a) a scalar offset, (b) ``spec=K`` draft
rows per stream, (c) per-stream offset vectors and per-row RoPE, (d) the
head+ring cache mask (``ring=``), (h) g32 weights.

Tolerances: both sides quantize the activations with the same formula
and contract int8 codes exactly, so what is left is float32 summation
order (norms, scores, softmax sums, P.V): 1e-5 of the largest value for
x_out and the logits (measured: below 5e-7).  k_new/v_new are bf16
roundings of f32 values that agree to that order: one bf16 ulp of the
largest value (measured: bit-equal).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from voxtral_tpu.ops import decode_step_pallas as jdsp
from voxtral_tpu.ops.w8 import quantize_w8_rowwise as jax_quantize_w8
from voxtral_tpu_torch import convert, device
from voxtral_tpu_torch.ops import decode_step as tdsp


# The port's entry points default to the card: these tests name the CPU.
def params_from_numpy(tree, dev="cpu"):
    return convert.params_from_numpy(tree, dev)


def to_torch(a, dev="cpu"):
    return device.to_torch(a, dev)

L, B, S, D = 3, 2, 16, 256
N_HEADS, N_KV, HEAD_DIM, HIDDEN = 8, 2, 32, 512
T_COND, V = 8, 1024
EPS = 1e-5

X_RTOL = 1e-5     # of max |x_out| / max |logits|: f32 summation order
KV_RTOL = 2 ** -8  # of max |k| / |v|: one bf16 ulp


def _w8_stack(rng, n, k):
    per = [jax_quantize_w8((rng.normal(size=(n, k)) * 0.05)
                           .astype(np.float32))["w8"] for _ in range(L)]
    return {"w8": {"codes": np.stack([p["codes"] for p in per]),
                   "scale": np.stack([p["scale"] for p in per])}}


def build_inputs():
    """numpy decoder params, t_embed, head-major bf16 caches, x, lm table."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    nq, nkv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM
    params = {"layers": {
        "ada": {"w0": _w8_stack(rng, T_COND, D), "w2": _w8_stack(rng, D, T_COND)},
        "attention_norm": (1.0 + rng.normal(size=(L, D)) * 0.1).astype(np.float32),
        "attention": {"wq": _w8_stack(rng, nq, D), "wk": _w8_stack(rng, nkv, D),
                      "wv": _w8_stack(rng, nkv, D), "wo": _w8_stack(rng, D, nq)},
        "ffn_norm": (1.0 + rng.normal(size=(L, D)) * 0.1).astype(np.float32),
        "ffn": {"w1": _w8_stack(rng, HIDDEN, D), "w2": _w8_stack(rng, D, HIDDEN),
                "w3": _w8_stack(rng, HIDDEN, D)},
    }}
    bf16 = np.dtype(ml_dtypes.bfloat16)
    t_embed = (rng.normal(size=(1, 1, D)) * 0.3).astype(np.float32)
    shape = (L, B, N_KV, S, HEAD_DIM)
    k_cache = (rng.normal(size=shape) * 0.4).astype(bf16)
    v_cache = (rng.normal(size=shape) * 0.4).astype(bf16)
    x = (rng.normal(size=(B, D)) * 0.5).astype(np.float32)
    lm = jax_quantize_w8((rng.normal(size=(V, D)) * 0.05).astype(np.float32))["w8"]
    final_norm = (1.0 + rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return params, t_embed, k_cache, v_cache, x, lm, final_norm


@pytest.fixture(scope="module")
def inputs():
    return build_inputs()


def _jax_fused(params):
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    return tree, jdsp.fuse_decode_weights(tree)


def test_fuse_decode_weights_matches_jax(inputs):
    params = inputs[0]
    _, jf = _jax_fused(params)
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    assert set(tf) == set(jf)
    for name in jf:
        np.testing.assert_array_equal(tf[name].numpy(), np.asarray(jf[name]),
                                      err_msg=name)


def test_ada_vectors_match_jax(inputs):
    params, t_embed = inputs[0], inputs[1]
    jtree, _ = _jax_fused(params)
    ref = np.asarray(jdsp.ada_vectors(jtree, jnp.asarray(t_embed)))
    got = tdsp.ada_vectors(params_from_numpy(params), to_torch(t_embed))
    assert got.shape == (L, D) and got.dtype == torch.float32
    # f32 end to end: summation order only (measured 1.2e-7).
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos", [0, 5, 4095])
def test_rope_pair_vectors_match_jax(pos):
    jc, js = jdsp.rope_pair_vectors(jnp.asarray(pos), HEAD_DIM, theta=1e6)
    tc, ts = tdsp.rope_pair_vectors(pos, HEAD_DIM, theta=1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)


@pytest.mark.parametrize("offset,window", [
    (0, None),        # empty cache: only the fresh token
    (7, None),        # mid
    (S - 1, 8192),    # full cache, production window
    (12, 4),          # the window's lower bound binds
])
def test_decode_stack_step_plain_matches_jax(inputs, offset, window):
    params, t_embed, k_cache, v_cache, x, lm, final_norm = inputs
    jtree, jf = _jax_fused(params)
    adav = jdsp.ada_vectors(jtree, jnp.asarray(t_embed))
    cos_p, sin_p = jdsp.rope_pair_vectors(jnp.asarray(offset, jnp.int32),
                                          HEAD_DIM, theta=1e6)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS)
    jx, jk, jv, jlog = jdsp.decode_stack_step(
        jnp.asarray(x), jnp.asarray(offset, jnp.int32),
        jf["attn_norm"], jf["ffn_norm"], adav,
        jf["sqkv"], jf["so"], jf["s13"], jf["s2"], cos_p, sin_p,
        jnp.asarray(k_cache), jnp.asarray(v_cache),
        jf["wqkv"], jf["wo"], jf["w13"], jf["w2"],
        final_norm=jnp.asarray(final_norm), lm_codes=jnp.asarray(lm["codes"]),
        lm_scale=jnp.asarray(lm["scale"]), interpret=True, window=window,
        **kw)

    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    tx, tk, tv, tlog = tdsp.decode_stack_step(
        to_torch(x), offset, tf["attn_norm"], tf["ffn_norm"],
        to_torch(np.asarray(adav)), tf["sqkv"], tf["so"], tf["s13"],
        tf["s2"], to_torch(np.asarray(cos_p)), to_torch(np.asarray(sin_p)),
        to_torch(k_cache), to_torch(v_cache),
        tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
        final_norm=to_torch(final_norm), lm_codes=to_torch(lm["codes"]),
        lm_scale=to_torch(lm["scale"]), window=window, **kw)

    assert tk.dtype == torch.bfloat16 and tk.shape == (L, B, N_KV, HEAD_DIM)
    jx, jlog = np.asarray(jx), np.asarray(jlog)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                               atol=X_RTOL * np.abs(jx).max())
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                               atol=X_RTOL * np.abs(jlog).max())
    for got, ref in ((tk, jk), (tv, jv)):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=KV_RTOL * np.abs(ref).max())
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(), jlog.argmax(-1))


def _rows_inputs(inputs, offs, spec, seed=5):
    """Spec inputs: x [Bc * spec, D] rows ordered (stream, slot), per-row
    RoPE vectors at offs[b] + j, caches of Bc = len(offs) streams."""
    params, t_embed, k_cache, v_cache, _, lm, final_norm = inputs
    bc = len(offs)
    idx = np.arange(bc) % B
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(bc * spec, D)) * 0.5).astype(np.float32)
    pos = (np.asarray(offs)[:, None] + np.arange(spec)[None]).reshape(-1)
    cos, sin = jax.vmap(lambda q: jdsp.rope_pair_vectors(
        q, HEAD_DIM, theta=1e6))(jnp.asarray(pos, jnp.int32))
    return (params, t_embed, k_cache[:, idx], v_cache[:, idx], x,
            np.asarray(cos), np.asarray(sin), lm, final_norm)


def _jax_and_port(inputs, offs, spec, window, ring=None):
    """(JAX interpret-mode outputs, port outputs) of one spec step."""
    (params, t_embed, kc, vc, x, cos, sin, lm,
     final_norm) = _rows_inputs(inputs, offs, spec)
    jtree, jf = _jax_fused(params)
    adav = jdsp.ada_vectors(jtree, jnp.asarray(t_embed))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=window)
    ref = jdsp.decode_stack_step(
        jnp.asarray(x), jnp.asarray(offs, jnp.int32),
        jf["attn_norm"], jf["ffn_norm"], adav,
        jf["sqkv"], jf["so"], jf["s13"], jf["s2"], jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(kc), jnp.asarray(vc),
        jf["wqkv"], jf["wo"], jf["w13"], jf["w2"],
        final_norm=jnp.asarray(final_norm), lm_codes=jnp.asarray(lm["codes"]),
        lm_scale=jnp.asarray(lm["scale"]), interpret=True, spec=spec,
        ring=ring, **kw)
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    got = tdsp.decode_stack_step(
        to_torch(x), torch.tensor(offs, dtype=torch.int32), tf["attn_norm"],
        tf["ffn_norm"], to_torch(np.asarray(adav)), tf["sqkv"], tf["so"],
        tf["s13"], tf["s2"], to_torch(cos), to_torch(sin), to_torch(kc),
        to_torch(vc), tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
        final_norm=to_torch(final_norm), lm_codes=to_torch(lm["codes"]),
        lm_scale=to_torch(lm["scale"]), spec=spec, ring=ring, **kw)
    return ref, got


def _assert_close_to_jax(ref, got, rows):
    jx, jk, jv, jlog = ref
    tx, tk, tv, tlog = got
    assert tx.shape == (rows, D) and tlog.shape == (rows, V)
    assert tk.dtype == torch.bfloat16 and tk.shape == (L, rows, N_KV, HEAD_DIM)
    jx, jlog = np.asarray(jx), np.asarray(jlog)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                               atol=X_RTOL * np.abs(jx).max())
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                               atol=X_RTOL * np.abs(jlog).max())
    for g, r in ((tk, jk), (tv, jv)):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=KV_RTOL * np.abs(r).max())
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(), jlog.argmax(-1))


@pytest.mark.parametrize("spec", [2, 3])
@pytest.mark.parametrize("window", [None, 4, 1])
def test_decode_stack_step_spec_plain_matches_jax(inputs, spec, window):
    """Mode (b): K draft rows per stream, distinct per-stream offsets; the
    window 4 bounds the cache from below, the window 1 also drops the
    fresh rows i < j - 1 (JAX :875-876)."""
    offs = [5, 11]
    ref, got = _jax_and_port(inputs, offs, spec, window)
    _assert_close_to_jax(ref, got, len(offs) * spec)


def test_decode_stack_step_offset_vector_plain_matches_jax(inputs):
    """Mode (c): spec = 1, one offset and one RoPE pair per row."""
    ref, got = _jax_and_port(inputs, [3, 12], 1, 8)
    _assert_close_to_jax(ref, got, 2)


def test_decode_stack_step_spec_guards(inputs):
    params, _, k_cache, v_cache, x, lm, final_norm = inputs
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    c, s = tdsp.rope_pair_vectors(3, HEAD_DIM)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS)

    def step(rows, spec):
        xr = torch.zeros((rows, D))
        return tdsp.decode_stack_step(
            xr, 3, tf["attn_norm"], tf["ffn_norm"], torch.ones((L, D)),
            tf["sqkv"], tf["so"], tf["s13"], tf["s2"], c, s,
            to_torch(k_cache), to_torch(v_cache), tf["wqkv"], tf["wo"],
            tf["w13"], tf["w2"], spec=spec, **kw)

    with pytest.raises(ValueError, match="must divide the row count"):
        step(5, 2)
    with pytest.raises(ValueError, match=r"cache rows 2 != streams 3"):
        step(6, 2)
    assert step(4, 2)[0].shape == (4, D)


def test_decode_stack_step_wrapper_on_cpu_counts_no_launch(inputs):
    params, _, k_cache, v_cache, x, lm, final_norm = inputs
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    ada = torch.ones((L, D))
    c, s = tdsp.rope_pair_vectors(3, HEAD_DIM)
    args = (to_torch(x), 3, tf["attn_norm"], tf["ffn_norm"], ada, tf["sqkv"],
            tf["so"], tf["s13"], tf["s2"], c, s, to_torch(k_cache),
            to_torch(v_cache), tf["wqkv"], tf["wo"], tf["w13"], tf["w2"])
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS)
    before = tdsp.decode_stack_step.launches
    out = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    assert tdsp.decode_stack_step.launches == before
    assert len(out) == 3
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [B, 9])
def test_decode_stack_step_kernel_matches_plain_on_card(inputs, rows):
    """Runs on the card only (the kernel has no CPU mode); 9 rows take
    the GEMV's second group of eight."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    params, t_embed, k_cache, v_cache, x, lm, final_norm = inputs
    idx = np.arange(rows) % B
    x, k_cache, v_cache = x[idx], k_cache[:, idx], v_cache[:, idx]
    dev = torch.device("cuda")
    tf = tdsp.fuse_decode_weights(params_from_numpy(params, dev))
    ada = tdsp.ada_vectors(params_from_numpy(params, dev), to_torch(t_embed, dev))
    c, s = tdsp.rope_pair_vectors(12, HEAD_DIM, device=dev)
    args = (to_torch(x, dev), 12, tf["attn_norm"], tf["ffn_norm"], ada,
            tf["sqkv"], tf["so"], tf["s13"], tf["s2"], c, s,
            to_torch(k_cache, dev), to_torch(v_cache, dev),
            tf["wqkv"], tf["wo"], tf["w13"], tf["w2"], to_torch(final_norm, dev),
            to_torch(lm["codes"], dev), to_torch(lm["scale"], dev))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS, window=8)
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        # Same tolerance as against JAX: f32 summation order differs
        # between the kernel's block reductions and the plain ops.
        r = r.float()
        torch.testing.assert_close(g.float(), r, rtol=0,
                                   atol=max(X_RTOL, KV_RTOL if g.dtype
                                            == torch.bfloat16 else 0)
                                   * r.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec", [
    ([5, 11], 3),                          # 6 rows: the dp4a GEMV
    ([2, 7, 9, 13], 4),                    # 16 rows: the int8 mma GEMV
    ([1, 3, 4, 6, 8, 10, 12, 14], 8),      # 64 rows: four mma row tiles
    ([3, 12, 0, 16], 1),                   # mode (c): offsets per row
])
def test_decode_stack_step_spec_kernel_matches_plain_on_card(inputs, offs,
                                                             spec):
    """Modes (b) and (c) on the card against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    (params, t_embed, kc, vc, x, cos, sin, lm,
     final_norm) = _rows_inputs(inputs, offs, spec)
    dev = torch.device("cuda")
    tf = tdsp.fuse_decode_weights(params_from_numpy(params, dev))
    ada = tdsp.ada_vectors(params_from_numpy(params, dev),
                           to_torch(t_embed, dev))
    args = (to_torch(x, dev), torch.tensor(offs, dtype=torch.int32,
                                           device=dev),
            tf["attn_norm"], tf["ffn_norm"], ada, tf["sqkv"], tf["so"],
            tf["s13"], tf["s2"], to_torch(cos, dev), to_torch(sin, dev),
            to_torch(kc, dev), to_torch(vc, dev), tf["wqkv"], tf["wo"],
            tf["w13"], tf["w2"], to_torch(final_norm, dev),
            to_torch(lm["codes"], dev), to_torch(lm["scale"], dev))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8, spec=spec)
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.float()
        torch.testing.assert_close(g.float(), r, rtol=0,
                                   atol=max(X_RTOL, KV_RTOL if g.dtype
                                            == torch.bfloat16 else 0)
                                   * r.abs().max().item())
    assert torch.equal(got[3].argmax(-1), ref[3].argmax(-1))


# ---------------------------------------------------------------------------
# Mode (h): g32 (q4g) weights — int8 codes with f16 group scales
# ---------------------------------------------------------------------------
#
# The geometry above qualifies (D, n_heads * head_dim and HIDDEN are
# multiples of 128, as scripts/q4_error_report.py::error_cfg).  Both sides
# quantize the activations with the same formula and take exact group
# dots; JAX sums z_g * s_g in f32 over the groups, the port in f64
# rounded once, so an output differs by f32 summation order — and a
# one-ulp difference can move an int8 activation code of the next
# layer.  Tolerance: 1e-5 of the largest value for x_out and the logits
# (G32_RTOL; measured below 4e-7), one bf16 ulp for k/v; argmax equal.

G32_RTOL = 1e-5


def _q4_stack(rng, n, k):
    from voxtral_tpu.ops.q4 import quantize_q4_0, repack_q4_0

    per = [repack_q4_0(quantize_q4_0((rng.normal(size=(n, k)) * 0.05)
                                     .astype(np.float32)), (n, k))
           for _ in range(L)]
    return {"q4": {key: np.stack([p[key] for p in per]) for key in per[0]}}


def build_q4g_params():
    """numpy q4g decoder params (unpacked q4 leaves, a q4 table)."""
    from voxtral_tpu.ops.q4 import quantize_q4_0, repack_q4_0

    rng = np.random.default_rng(11)
    nq, nkv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM
    table = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    return {
        "tok_embeddings": {"q4": repack_q4_0(quantize_q4_0(table), (V, D))},
        "layers": {
            "ada": {"w0": _q4_stack(rng, T_COND, D),
                    "w2": _w8_stack(rng, D, T_COND)},
            "attention_norm": (1.0 + rng.normal(size=(L, D)) * 0.1).astype(np.float32),
            "attention": {"wq": _q4_stack(rng, nq, D),
                          "wk": _q4_stack(rng, nkv, D),
                          "wv": _q4_stack(rng, nkv, D),
                          "wo": _q4_stack(rng, D, nq)},
            "ffn_norm": (1.0 + rng.normal(size=(L, D)) * 0.1).astype(np.float32),
            "ffn": {"w1": _q4_stack(rng, HIDDEN, D),
                    "w2": _q4_stack(rng, D, HIDDEN),
                    "w3": _q4_stack(rng, HIDDEN, D)},
        },
        "norm": (1.0 + rng.normal(size=(D,)) * 0.1).astype(np.float32),
    }


@pytest.fixture(scope="module")
def q4g_params():
    return build_q4g_params()


def test_fuse_decode_weights_q4g_matches_jax(q4g_params):
    """The port keeps the w8 code layout [L, N, K] and f16 scales
    [L, N, K/32]; JAX's Mosaic layouts hold the same values."""
    jf = jdsp.fuse_decode_weights_q4g(
        jax.tree_util.tree_map(jnp.asarray, q4g_params))
    tf = tdsp.fuse_decode_weights_q4g(params_from_numpy(q4g_params))
    assert set(tf) == set(jf)

    def codes(a):  # [..., SB, N, 128] -> [..., N, K]
        a = np.swapaxes(np.asarray(a), -3, -2)
        return a.reshape(*a.shape[:-2], -1)

    def scales(a):  # [..., 4 SB, 1, N] r-major -> [..., N, K/32]
        a = np.asarray(a)[..., 0, :]
        *lead, g, n = a.shape
        a = a.reshape(*lead, 4, g // 4, n)
        return np.moveaxis(a, (-3, -2, -1), (-1, -2, -3)).reshape(*lead, n, g)

    for name in ("wqkv", "wo", "w13", "w2", "lm_codes"):
        np.testing.assert_array_equal(tf[name].numpy(), codes(jf[name]),
                                      err_msg=name)
    for name in ("sqkv", "so", "s13", "s2", "lm_scale"):
        assert tf[name].dtype == torch.float16
        np.testing.assert_array_equal(tf[name].float().numpy(),
                                      scales(jf[name]), err_msg=name)
    for name in ("attn_norm", "ffn_norm"):
        np.testing.assert_array_equal(tf[name].numpy(), np.asarray(jf[name]))


def test_megakernel_mode_and_q4g_geometry_match_jax(q4g_params):
    from voxtral_tpu.config import LanguageModelConfig
    from voxtral_tpu.ops.q4 import quantize_q4_0, repack_q4_0
    from voxtral_tpu.ops.q4_pallas import pack_codes, transpose_scales

    w8 = build_inputs()[0]
    packed = jax.tree_util.tree_map(lambda a: a, q4g_params)
    leaf = repack_q4_0(quantize_q4_0(np.ones((256, 256), np.float32)),
                       (256, 256))
    packed["layers"]["attention"]["wq"] = {"q4": {
        "codes_packed": pack_codes(leaf["codes"])[None],
        "scales_t": transpose_scales(leaf["scales"])[None]}}
    trees = {"w8": w8, "q4g": q4g_params, "packed": packed}
    for name, tree in trees.items():
        for hd in (HEAD_DIM, 33):
            got = tdsp.megakernel_mode(params_from_numpy(tree), hd)
            ref = jdsp.megakernel_mode(
                jax.tree_util.tree_map(jnp.asarray, tree), hd)
            assert got == ref, (name, hd)
    assert tdsp.megakernel_mode(params_from_numpy(q4g_params), 32) == "q4g"
    for dims in ((256, 8, 32, 512), (192, 4, 48, 384), (256, 8, 32, 320)):
        d, h, hd, f = dims
        lm = LanguageModelConfig(dim=d, n_heads=h, n_kv_heads=2, head_dim=hd,
                                 hidden_dim=f)
        assert tdsp.q4g_geometry_ok(lm) == jdsp.q4g_geometry_ok(lm), dims


def _g32_rows(bc: int, spec: int) -> np.ndarray:
    """The step's input rows for ``bc`` streams of ``spec`` rows."""
    rng = np.random.default_rng(17 + bc * spec)
    return (rng.normal(size=(bc * spec, D)) * 0.5).astype(np.float32)


def _g32_jax_and_port(q4g_params, inputs, offs, spec, window, ring=None,
                      lm_argmax=False, x=None, idx=None):
    """(JAX interpret-mode outputs, port outputs) of one g32 step with the
    g32 lm fold (``lm_argmax``: mode (i), the token); offs None: mode (a),
    a scalar offset.  ``x`` / ``idx`` replace the input rows and the
    streams' cache copies (default: :func:`_g32_rows`, stream b on cache
    b % B)."""
    _, t_embed, k_cache, v_cache, _, _, _ = inputs
    offsets = [7] if offs is None else offs
    bc = len(offsets)
    idx = np.arange(bc) % B if idx is None else np.asarray(idx)
    kc, vc = k_cache[:, idx], v_cache[:, idx]
    x = _g32_rows(bc, spec) if x is None else x
    pos = (np.asarray(offsets)[:, None] + np.arange(spec)[None]).reshape(-1)
    cos, sin = jax.vmap(lambda q: jdsp.rope_pair_vectors(
        q, HEAD_DIM, theta=1e6))(jnp.asarray(pos, jnp.int32))
    cos, sin = np.asarray(cos), np.asarray(sin)
    if offs is None:
        cos, sin = cos[0], sin[0]
    jtree = jax.tree_util.tree_map(jnp.asarray, q4g_params)
    jf = jdsp.fuse_decode_weights_q4g(jtree)
    adav = jdsp.ada_vectors(jtree, jnp.asarray(t_embed))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=window)
    joff = (jnp.asarray(offsets[0], jnp.int32) if offs is None
            else jnp.asarray(offs, jnp.int32))
    ref = jdsp.decode_stack_step(
        jnp.asarray(x), joff, jf["attn_norm"], jf["ffn_norm"], adav,
        jf["sqkv"], jf["so"], jf["s13"], jf["s2"], jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(kc), jnp.asarray(vc),
        jf["wqkv"], jf["wo"], jf["w13"], jf["w2"],
        final_norm=jtree["norm"], lm_codes=jf["lm_codes"],
        lm_scale=jf["lm_scale"], interpret=True, spec=spec, ring=ring,
        lm_argmax=lm_argmax, **kw)
    tp = params_from_numpy(q4g_params)
    tf = tdsp.fuse_decode_weights_q4g(tp)
    toff = (offsets[0] if offs is None
            else torch.tensor(offs, dtype=torch.int32))
    got = tdsp.decode_stack_step(
        to_torch(x), toff, tf["attn_norm"], tf["ffn_norm"],
        to_torch(np.asarray(adav)), tf["sqkv"], tf["so"], tf["s13"],
        tf["s2"], to_torch(cos), to_torch(sin), to_torch(kc), to_torch(vc),
        tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
        final_norm=tp["norm"], lm_codes=tf["lm_codes"],
        lm_scale=tf["lm_scale"], spec=spec, ring=ring, lm_argmax=lm_argmax,
        **kw)
    return ref, got


def _resolve_tie(monkeypatch, call: int, row: int, col: int) -> list:
    """Replace the step's row quantization so that its ``call``-th call
    (0-based, in the plain step's order: per layer qkv, wo, w13, w2)
    rounds an exact tie (a code of k + 0.5) away from zero instead of to
    even, after checking that the only exact tie of that call is at
    (``row``, ``col``).  Returns the list of calls made."""
    quant = tdsp._quant
    calls = []

    def resolved(h):
        xq, sx = quant(h)
        if len(calls) == call:
            r = h.float() / sx
            tie = (r - r.floor()) == 0.5
            assert tie.nonzero().tolist() == [[row, col]]
            up = torch.sign(r) * torch.ceil(r.abs())
            xq = torch.where(tie, up, xq.float()).to(torch.int8)
        calls.append(len(calls))
        return xq, sx

    monkeypatch.setattr(tdsp, "_quant", resolved)
    return calls


@pytest.mark.parametrize("offs,spec,tie", [
    ([5, 11], 1, None),                    # 2 rows
    ([5, 11], 4, None),                    # 8 rows
    ([5, 11, 7], 4, None),                 # 12 rows: two 8-row tiles
    ([2, 3, 4, 5, 6, 7, 8, 8], 8, None),   # 64 rows: one weight pass
    # 64 rows, eight streams at offsets 1..8: the int8 code of layer 2's
    # qkv input, row 2, element 196 is an exact tie (50.5) on the port's
    # side, and JAX's input there is one f32 ulp above it (code 51).
    ([1, 2, 3, 4, 5, 6, 7, 8], 8, (8, 2, 196)),
], ids=["2 rows", "8 rows", "12 rows", "64 rows", "64 rows from offset 1"])
@pytest.mark.parametrize("lm_argmax", [False, True], ids=["h", "i"])
def test_decode_stack_step_g32_plain_matches_jax_past_one_row(
        q4g_params, inputs, offs, spec, tie, lm_argmax, monkeypatch):
    """Modes (h) and (i) over g32 weights at the row counts the weight
    stream takes on the card (2, 8, 12, 64): the plain version the
    stream is held to against JAX's interpret-mode step, x_out and the
    logits within G32_RTOL, the token equal.

    At offsets 1..8 the two sides part at one rounding tie, not at the
    spec rows' offsets, masks or fresh rows: each stream alone gives the
    same rows as in the batch on both sides, and the layer inputs agree
    to an ulp up to the tie.  Layer 1's output, row 2, lands on an exact
    int8 tie of layer 2's row quantization on the port's side (f64 sums
    rounded once) and one ulp above it on JAX's (f32 sums); round-half-
    to-even gives codes 50 and 51.  The case resolves that one tie as
    JAX's input does, after checking it is the only exact tie of that
    call, and holds the rest to the same tolerance."""
    calls = _resolve_tie(monkeypatch, *tie) if tie else None
    (jx, _, _, jlast), (tx, _, _, tlast) = _g32_jax_and_port(
        q4g_params, inputs, offs, spec, None, lm_argmax=lm_argmax)
    if tie:
        assert len(calls) > tie[0]  # the resolved call was made
    rows = len(offs) * spec
    jx = np.asarray(jx)
    assert tx.shape == (rows, D)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                               atol=G32_RTOL * np.abs(jx).max())
    if lm_argmax:
        assert tlast.shape == (rows, 1) and tlast.dtype == torch.int32
        np.testing.assert_array_equal(tlast.numpy().ravel(),
                                      np.asarray(jlast).ravel())
    else:
        jlast = np.asarray(jlast)
        np.testing.assert_allclose(tlast.numpy(), jlast, rtol=0,
                                   atol=G32_RTOL * np.abs(jlast).max())


def test_g32_parting_at_offsets_1_to_8_is_one_stream_and_one_tie(
        q4g_params, inputs):
    """Where the 64-row case from offset 1 parts without the tie's
    resolution: only rows 2-7 of stream 0 (row 2 holds the tie, rows 3-7
    attend to its fresh K / V), and stream 0 alone, on the same rows and
    cache, gives the rows it gives in the batch on each side: the
    parting is that stream's values, not the batch's offsets."""
    offs = [1, 2, 3, 4, 5, 6, 7, 8]
    (jx, _, _, _), (tx, _, _, _) = _g32_jax_and_port(
        q4g_params, inputs, offs, 8, None)
    jx, tx = np.asarray(jx), tx.numpy()
    apart = np.abs(tx - jx).max(-1) > G32_RTOL * np.abs(jx).max()
    assert np.flatnonzero(apart).tolist() == [2, 3, 4, 5, 6, 7]
    (j1, _, _, _), (t1, _, _, _) = _g32_jax_and_port(
        q4g_params, inputs, [1], 8, None, x=_g32_rows(8, 8)[:8], idx=[0])
    np.testing.assert_array_equal(np.asarray(j1), jx[:8])
    np.testing.assert_array_equal(t1.numpy(), tx[:8])


@pytest.mark.parametrize("offs,spec,window", [
    (None, 1, None),      # mode (a): one row per stream, scalar offset
    (None, 1, 4),         # the window's lower bound binds
    ([5, 11], 3, None),   # mode (b): spec = 3, per-stream offsets
    ([3, 12], 1, 8),      # mode (c): an offset and RoPE pair per row
])
def test_decode_stack_step_g32_plain_matches_jax(q4g_params, inputs, offs,
                                                 spec, window):
    (jx, jk, jv, jlog), (tx, tk, tv, tlog) = _g32_jax_and_port(
        q4g_params, inputs, offs, spec, window)
    rows = (1 if offs is None else len(offs)) * spec
    assert tx.shape == (rows, D) and tlog.shape == (rows, V)
    jx, jlog = np.asarray(jx), np.asarray(jlog)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                               atol=G32_RTOL * np.abs(jx).max())
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                               atol=G32_RTOL * np.abs(jlog).max())
    for g, r in ((tk, jk), (tv, jv)):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=KV_RTOL * np.abs(r).max())
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(), jlog.argmax(-1))


def test_g32_matmul_plain_matches_q4g_matmul_a8(q4g_params):
    """The step's group-32 GEMV (f64 group sum) against the f32 reference
    of ops/q4.py on the same quantized rows."""
    from voxtral_tpu_torch.ops.q4 import q4g_matmul_a8
    from voxtral_tpu_torch.ops.w8 import quantize_activations

    leaf = params_from_numpy(q4g_params)["tok_embeddings"]["q4"]
    x = to_torch((np.random.default_rng(3).normal(size=(3, D))).astype(
        np.float32))
    got = tdsp.g32_matmul_plain(*quantize_activations(x), leaf["codes"],
                                leaf["scales"])
    ref = q4g_matmul_a8(x, leaf["codes"], leaf["scales"])
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-6 * ref.abs().max().item())


def test_decode_stack_step_g32_guards(q4g_params, inputs):
    _, _, k_cache, v_cache, x, _, _ = inputs
    tp = params_from_numpy(q4g_params)
    tf = tdsp.fuse_decode_weights_q4g(tp)
    c, s = tdsp.rope_pair_vectors(3, HEAD_DIM)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS)

    def step(**over):
        a = dict(tf, **over)
        return tdsp.decode_stack_step(
            to_torch(x), 3, a["attn_norm"], a["ffn_norm"], torch.ones((L, D)),
            a["sqkv"], a["so"], a["s13"], a["s2"], c, s, to_torch(k_cache),
            to_torch(v_cache), a["wqkv"], a["wo"], a["w13"], a["w2"],
            final_norm=tp["norm"], lm_codes=a["lm_codes"],
            lm_scale=a["lm_scale"], **kw)

    with pytest.raises(ValueError, match="must be int8 codes"):
        step(wo=tf["wo"].float())
    with pytest.raises(ValueError, match="group-scale stacks"):
        step(so=tf["so"][:, :, :-1])
    with pytest.raises(ValueError, match="g32 lm fold needs"):
        step(lm_scale=tf["lm_scale"][:, 0])
    with pytest.raises(ValueError, match="must match the weight mode"):
        step(lm_codes=tf["lm_codes"].float())
    with pytest.raises(ValueError, match="unpacked q4 leaves"):
        packed = {"q4": {"codes_packed": torch.zeros((L, 32, 256),
                                                     dtype=torch.int32)}}
        tdsp.fuse_decode_weights_q4g(
            {"layers": dict(tp["layers"], attention=dict(
                tp["layers"]["attention"], wq=packed))})
    assert step()[0].shape == (B, D)


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec", [
    ([7, 9], 1),                           # mode (a): the dp4a g32 GEMV
    ([5, 11], 3),                          # 6 rows
    ([2, 7, 9, 13], 4),                    # 16 rows: the g32 mma GEMV
    ([1, 3, 4, 6, 8, 10, 12, 14], 8),      # 64 rows: four mma row tiles
    ([3, 12, 0, 16], 1),                   # mode (c)
])
def test_decode_stack_step_g32_kernel_matches_plain_on_card(q4g_params,
                                                            inputs, offs,
                                                            spec):
    """Mode (h) on the card against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, t_embed, k_cache, v_cache, _, _, _ = inputs
    dev = torch.device("cuda")
    bc = len(offs)
    idx = np.arange(bc) % B
    rng = np.random.default_rng(bc * spec)
    x = (rng.normal(size=(bc * spec, D)) * 0.5).astype(np.float32)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    pos = (off[:, None] + torch.arange(spec, device=dev)).reshape(-1)
    c, s = tdsp.rope_pair_vectors(pos, HEAD_DIM, device=dev)
    tp = params_from_numpy(q4g_params, dev)
    tf = tdsp.fuse_decode_weights_q4g(tp)
    ada = tdsp.ada_vectors(tp, to_torch(t_embed, dev))
    args = (to_torch(x, dev), off, tf["attn_norm"], tf["ffn_norm"], ada,
            tf["sqkv"], tf["so"], tf["s13"], tf["s2"], c, s,
            to_torch(k_cache[:, idx], dev), to_torch(v_cache[:, idx], dev),
            tf["wqkv"], tf["wo"], tf["w13"], tf["w2"], tp["norm"].float(),
            tf["lm_codes"], tf["lm_scale"])
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8, spec=spec)
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.float()
        torch.testing.assert_close(g.float(), r, rtol=0,
                                   atol=max(X_RTOL, KV_RTOL if g.dtype
                                            == torch.bfloat16 else 0)
                                   * r.abs().max().item())
    assert torch.equal(got[3].argmax(-1), ref[3].argmax(-1))


# ---------------------------------------------------------------------------
# Mode (d): the head+ring cache of an unbounded stream
# ---------------------------------------------------------------------------
#
# S = 16 slots as (head, size) = (3, 13), window 8: slots [0, 3) hold
# positions [0, 3) for good, ring slot r the largest 3 + r + 13 c below
# the offset.  Offsets before the wrap (10), after it (20) and far past
# it, where the head has left the window (40); spec rows at 14 + j
# straddle the ring's end (their appends land at slots 14, 15, 3).
# Tolerances as above.

RING = (3, 13)


@pytest.mark.parametrize("offs,spec", [
    ([10, 20], 1),     # before / after the wrap, one offset per stream
    ([40, 20], 1),     # the head outside the window
    ([14, 27], 3),     # spec rows straddling the ring's end
    ([40, 10], 3),
])
def test_decode_stack_step_ring_plain_matches_jax(inputs, offs, spec):
    ref, got = _jax_and_port(inputs, offs, spec, 8, RING)
    _assert_close_to_jax(ref, got, len(offs) * spec)


@pytest.mark.parametrize("offs,spec", [(None, 1), ([14, 40], 3)])
def test_decode_stack_step_g32_ring_plain_matches_jax(q4g_params, inputs,
                                                      offs, spec):
    """Mode (d) x (h): g32 weights over a head+ring cache (the scalar
    offset 7 of mode (a) sits before the wrap)."""
    ref, got = _g32_jax_and_port(q4g_params, inputs, offs, spec, 8, RING)
    rows = (1 if offs is None else len(offs)) * spec
    jx, jk, jv, jlog = ref
    tx, tk, tv, tlog = got
    assert tx.shape == (rows, D)
    for g, r, tol in ((tx, jx, G32_RTOL), (tlog, jlog, G32_RTOL),
                      (tk, jk, KV_RTOL), (tv, jv, KV_RTOL)):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max())
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                  np.asarray(jlog).argmax(-1))


def test_decode_stack_step_ring_guards(inputs):
    """Ring offsets may pass S; a ring that does not fit S, or a cache
    whose score buffer outgrows shared memory, raises with the cause."""
    params, _, k_cache, v_cache, x, _, _ = inputs
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    c, s = tdsp.rope_pair_vectors(100, HEAD_DIM)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8)
    args = (to_torch(x), 100, tf["attn_norm"], tf["ffn_norm"],
            torch.ones((L, D)), tf["sqkv"], tf["so"], tf["s13"], tf["s2"],
            c, s, to_torch(k_cache), to_torch(v_cache), tf["wqkv"],
            tf["wo"], tf["w13"], tf["w2"])
    assert tdsp.decode_stack_step(*args, ring=RING, **kw)[0].shape == (B, D)
    with pytest.raises(ValueError, match="does not fit"):
        tdsp.check_geometry(S, HEAD_DIM, 8, 1, (3, 14))
    with pytest.raises(ValueError, match="shared memory"):
        tdsp.check_geometry(60000, HEAD_DIM, 59000, 1, (38, 59000))
    tdsp.check_geometry(8238, 128, 8192, 8, (38, 8200))  # the session's
    tdsp.check_geometry(60000, 128, 8192, 1)  # bounded: the window's span


def _ring_card_args(inputs, offs, spec, g32_params=None):
    """Card inputs for one mode (d) step: per-stream offsets, RoPE per
    row, ring caches of len(offs) streams."""
    dev = torch.device("cuda")
    _, t_embed, k_cache, v_cache, _, lm, final_norm = inputs
    bc = len(offs)
    idx = np.arange(bc) % B
    rng = np.random.default_rng(31 + bc * spec)
    x = (rng.normal(size=(bc * spec, D)) * 0.5).astype(np.float32)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    pos = (off[:, None] + torch.arange(spec, device=dev)).reshape(-1)
    c, s = tdsp.rope_pair_vectors(pos, HEAD_DIM, device=dev)
    if g32_params is None:
        tp = params_from_numpy(inputs[0], dev)
        tf = tdsp.fuse_decode_weights(tp)
        fold = (to_torch(final_norm, dev), to_torch(lm["codes"], dev),
                to_torch(lm["scale"], dev))
    else:
        tp = params_from_numpy(g32_params, dev)
        tf = tdsp.fuse_decode_weights_q4g(tp)
        fold = (tp["norm"].float(), tf["lm_codes"], tf["lm_scale"])
    ada = tdsp.ada_vectors(tp, to_torch(t_embed, dev))
    return (to_torch(x, dev), off, tf["attn_norm"], tf["ffn_norm"], ada,
            tf["sqkv"], tf["so"], tf["s13"], tf["s2"], c, s,
            to_torch(k_cache[:, idx], dev), to_torch(v_cache[:, idx], dev),
            tf["wqkv"], tf["wo"], tf["w13"], tf["w2"], *fold)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["w8", "g32"])
@pytest.mark.parametrize("offs,spec", [([10, 20], 1), ([40, 14], 1),
                                       ([14, 27], 3), ([40, 10, 3, 16], 4)])
def test_decode_stack_step_ring_kernel_matches_plain_on_card(
        q4g_params, inputs, weights, offs, spec):
    """Mode (d) on the card: bit-equal to the plain version (both sum in
    f64 and round once; tolerance as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = _ring_card_args(inputs, offs, spec,
                           q4g_params if weights == "g32" else None)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8, spec=spec, ring=RING)
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.float()
        torch.testing.assert_close(g.float(), r, rtol=0,
                                   atol=max(X_RTOL, KV_RTOL if g.dtype
                                            == torch.bfloat16 else 0)
                                   * r.abs().max().item())
    assert torch.equal(got[3].argmax(-1), ref[3].argmax(-1))


# ---------------------------------------------------------------------------
# Modes (e) and (f): the int8 KV cache and the chunked cache
# ---------------------------------------------------------------------------
#
# The int8 caches are JAX's ``quantize_kv`` of the bf16 caches above, the
# same codes and scales on both sides.  Every dot of mode (e) is an
# integer sum, so both sides agree exactly unless a float that feeds a
# rounding (q / sq, e * vs / se) differs in its last bits and lands on
# the other side of a half: one code of 127 flips by one, which moves a
# score by |k| sq ks (about 1e-2 of it) and an output by about 1e-3 of
# its largest value.  No flip occurs on these seeds, so the tolerance is
# mode (a)'s: 1e-5 of the largest value (f32 summation order).
# Mode (f) sums per chunk against a running max on both sides, the same
# tolerance.  Dead chunks are poisoned (NaN values and scales): a chunk
# outside [c_lo, n_used) must not be read.


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(4)
    v = (rng.normal(size=(3, 2, 5, 32)) * 0.4).astype(np.float32)
    v[0, 0, 0] = 0.0            # the 1e-8 floor
    v[1, 1, 2, :] = 0.5         # ties at +-127
    for dt in (jnp.float32, jnp.bfloat16):
        jq, js = jdsp.quantize_kv(jnp.asarray(v).astype(dt))
        tv = to_torch(v)
        if dt == jnp.bfloat16:
            tv = tv.to(torch.bfloat16)
        tq, ts = tdsp.quantize_kv(tv)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _kv_jax_and_port(inputs, offs, spec, window, ring=None, int8=False,
                     chunk=None, dead=None, poison=np.nan):
    """(JAX interpret-mode outputs, port outputs) of one step over int8
    and / or chunked caches.  ``dead``: a slot slice poisoned on both
    sides with ``poison``: NaN for chunks that must not be read, a large
    finite value for masked slots of a chunk that is."""
    (params, t_embed, kc, vc, x, cos, sin, lm,
     final_norm) = _rows_inputs(inputs, offs, spec)
    kc, vc = jnp.asarray(kc), jnp.asarray(vc)
    scales = {}
    if int8:
        kc, ks = jdsp.quantize_kv(kc)
        vc, vs = jdsp.quantize_kv(vc)
        if dead is not None:
            ks = ks.at[:, :, :, dead].set(poison)
            vs = vs.at[:, :, :, dead].set(poison)
            kc = kc.at[:, :, :, dead].set(127)
            vc = vc.at[:, :, :, dead].set(127)
        scales = dict(k_scales=ks, v_scales=vs)
    elif dead is not None:
        kc = kc.at[:, :, :, dead].set(poison)
        vc = vc.at[:, :, :, dead].set(poison)
    jtree, jf = _jax_fused(params)
    adav = jdsp.ada_vectors(jtree, jnp.asarray(t_embed))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=window, spec=spec, ring=ring, cache_chunk=chunk)
    ref = jdsp.decode_stack_step(
        jnp.asarray(x), jnp.asarray(offs, jnp.int32),
        jf["attn_norm"], jf["ffn_norm"], adav,
        jf["sqkv"], jf["so"], jf["s13"], jf["s2"], jnp.asarray(cos),
        jnp.asarray(sin), kc, vc, jf["wqkv"], jf["wo"], jf["w13"], jf["w2"],
        final_norm=jnp.asarray(final_norm), lm_codes=jnp.asarray(lm["codes"]),
        lm_scale=jnp.asarray(lm["scale"]), interpret=True, **scales, **kw)
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))

    def cache(a):
        a = np.asarray(a) if a.dtype == jnp.int8 else np.asarray(
            a.astype(jnp.float32))
        t = to_torch(a)
        return t if t.dtype == torch.int8 else t.to(torch.bfloat16)

    tscales = {k: to_torch(np.asarray(v)) for k, v in scales.items()}
    got = tdsp.decode_stack_step(
        to_torch(x), torch.tensor(offs, dtype=torch.int32), tf["attn_norm"],
        tf["ffn_norm"], to_torch(np.asarray(adav)), tf["sqkv"], tf["so"],
        tf["s13"], tf["s2"], to_torch(cos), to_torch(sin), cache(kc),
        cache(vc), tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
        final_norm=to_torch(final_norm), lm_codes=to_torch(lm["codes"]),
        lm_scale=to_torch(lm["scale"]), **tscales, **kw)
    return ref, got


@pytest.mark.parametrize("offs,spec,window,ring", [
    ([7, 7], 1, None, None),      # sequential, no window
    ([3, 12], 1, 8, None),        # per-row offsets, the window binds
    ([0, 16], 1, 8, None),        # an empty and a full cache
    ([10, 20], 1, 8, RING),       # ring, before / after the wrap
    ([40, 14], 1, 8, RING),       # the head outside the window
    ([5, 11], 3, None, None),     # (e) x (b): spec rows, one requant group
    ([5, 11], 2, 1, None),        # the window drops fresh rows
    ([14, 27], 3, 8, RING),       # spec rows straddling the ring's end
])
def test_decode_stack_step_int8_kv_plain_matches_jax(inputs, offs, spec,
                                                     window, ring):
    ref, got = _kv_jax_and_port(inputs, offs, spec, window, ring, int8=True)
    _assert_close_to_jax(ref, got, len(offs) * spec)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("offs,window,ring,chunk,dead", [
    ([7, 5], 8, None, 8, slice(8, 16)),     # the trailing chunk is dead
    ([15, 14], 4, None, 4, slice(0, 8)),    # leading chunks below the band
    ([16, 3], 8, None, 8, None),            # both chunks, one row in each
    ([13, 9], 8, (4, 8), 8, slice(12, 16)),  # ring padded past head + size
    ([40, 5], 8, (4, 8), 4, slice(12, 16)),  # ... its last chunk is dead
    ([5, 3], 8, (4, 8), 4, slice(8, 16)),    # ring, filled to 5 of 12
])
def test_decode_stack_step_chunked_plain_matches_jax(inputs, int8, offs,
                                                     window, ring, chunk,
                                                     dead):
    # Slots [12, 16) of the first ring case share a live chunk: masked,
    # not skipped, so their poison is finite (0 * NaN would spread).
    poison = 1e3 if ring is not None and chunk == 8 else np.nan
    ref, got = _kv_jax_and_port(inputs, offs, 1, window, ring, int8=int8,
                                chunk=chunk, dead=dead, poison=poison)
    assert np.isfinite(np.asarray(ref[3])).all()
    _assert_close_to_jax(ref, got, len(offs))


def test_decode_stack_step_kv_mode_guards(inputs):
    params, _, k_cache, v_cache, x, _, _ = inputs
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    c, s = tdsp.rope_pair_vectors(3, HEAD_DIM)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS)
    kq, ks = tdsp.quantize_kv(to_torch(k_cache))
    vq, vs = tdsp.quantize_kv(to_torch(v_cache))

    def step(rows=B, kc=kq, vc=vq, **over):
        return tdsp.decode_stack_step(
            torch.zeros((rows, D)), 3, tf["attn_norm"], tf["ffn_norm"],
            torch.ones((L, D)), tf["sqkv"], tf["so"], tf["s13"], tf["s2"],
            c, s, kc, vc, tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
            **dict(kw, **over))

    with pytest.raises(ValueError, match="cache_chunk unsupported"):
        step(2 * B, k_scales=ks, v_scales=vs, spec=2, cache_chunk=8)
    with pytest.raises(ValueError, match="must divide S"):
        step(k_scales=ks, v_scales=vs, cache_chunk=5)
    with pytest.raises(ValueError, match="needs k_scales/v_scales"):
        step()
    with pytest.raises(ValueError, match="need int8 caches"):
        step(kc=to_torch(k_cache), vc=to_torch(v_cache), k_scales=ks,
             v_scales=vs)
    out = step(k_scales=ks, v_scales=vs, cache_chunk=8)
    assert out[1].dtype == torch.bfloat16  # k_new comes back bf16
    # Mode (f) needs the chunk's scores in shared memory, not S's.
    with pytest.raises(ValueError, match="shared memory"):
        tdsp.check_geometry(512 * 200, 128, 8192, 1, (38, 512 * 200 - 38))
    tdsp.check_geometry(512 * 200, 128, 8192, 1, (38, 512 * 200 - 38),
                        cache_chunk=512, kv_int8=True)
    with pytest.raises(ValueError, match="cache_chunk unsupported"):
        tdsp.check_geometry(1024, 128, 8192, 8, None, cache_chunk=512)
    assert (tdsp.attn_smem_bytes(8704, 128, 8192, 1, (38, 8666), 512, True)
            == 8 * 8 * 128 + 4 * (4 * 128 + 2 + 512))


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["w8", "g32"])
@pytest.mark.parametrize("offs,spec,ring,int8,chunk,dead", [
    ([7, 7], 1, None, True, None, None),            # (e)
    ([3, 12, 0, 16], 1, None, True, None, None),    # (e) x (c)
    ([10, 20, 40, 14], 1, RING, True, None, None),  # (e) x (d)
    ([5, 11], 3, None, True, None, None),           # (e) x (b)
    ([14, 27, 40, 10], 4, RING, True, None, None),  # 16 rows, ring
    ([7, 5], 1, None, False, 8, slice(8, 16)),      # (f) bf16, a dead chunk
    ([7, 5], 1, None, True, 8, slice(8, 16)),       # (f) int8
    ([15, 14, 13, 12], 1, None, True, 4, slice(0, 4)),
    ([13, 9], 1, (4, 8), False, 8, None),           # (f) ring, padded S
    ([40, 5], 1, (4, 8), True, 4, slice(12, 16)),
])
def test_decode_stack_step_kv_kernel_matches_plain_on_card(
        q4g_params, inputs, weights, offs, spec, ring, int8, chunk, dead):
    """Modes (e), (e) x (b) and (f) on the card: bit-equal to the plain
    version (integer dots; f64 sums rounded once), under the tolerance of
    the other modes.  Dead chunks hold NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = list(_ring_card_args(inputs, offs, spec,
                                q4g_params if weights == "g32" else None))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8, spec=spec, ring=ring, cache_chunk=chunk)
    kc, vc = args[11], args[12]
    if int8:
        (kc, ks), (vc, vs) = tdsp.quantize_kv(kc), tdsp.quantize_kv(vc)
        if dead is not None:
            ks[:, :, :, dead] = float("nan")
            vs[:, :, :, dead] = float("nan")
        kw.update(k_scales=ks, v_scales=vs)
    elif dead is not None:
        kc, vc = kc.clone(), vc.clone()
        kc[:, :, :, dead] = float("nan")
        vc[:, :, :, dead] = float("nan")
    args[11], args[12] = kc, vc
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.float()
        assert torch.isfinite(r).all()
        torch.testing.assert_close(g.float(), r, rtol=0,
                                   atol=max(X_RTOL, KV_RTOL if g.dtype
                                            == torch.bfloat16 else 0)
                                   * r.abs().max().item())
    assert torch.equal(got[3].argmax(-1), ref[3].argmax(-1))


# ---------------------------------------------------------------------------
# The cluster walk (csrc/attn_step.cuh) at caches long enough to split
# ---------------------------------------------------------------------------
#
# A head+ring cache of 640 slots spans 10 tiles of 64, so a cluster
# takes up to 10 blocks (4 at the 256-slot window of a bounded cache),
# each a piece: the merge of maxima, denominators, P.V partials and int8
# absmax across blocks is exercised, with the window full (bounded) and
# at four ring phases (offset below the head, the ring filling, wrapped,
# wrapped again).

BIG_S, BIG_RING, BIG_WINDOW = 640, (40, 600), 256


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec,ring,int8", [
    ([600, 640], 1, None, False),                      # window full
    ([30, 300, 660, 1500], 1, BIG_RING, False),        # (c) x (d)
    ([30, 300, 660, 1500], 1, BIG_RING, True),         # (e)
    ([30, 296, 660, 1500], 4, BIG_RING, True),         # (e) x (b)
    ([600, 636], 4, None, True),                       # (e) x (b) bounded
])
def test_decode_stack_step_cluster_kernel_matches_plain_on_card(
        inputs, offs, spec, ring, int8):
    """K1's cluster attention over a long cache, bit-equal to the plain
    version (torch.equal on every output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = list(_ring_card_args(inputs, offs, spec))
    dev = args[0].device
    g = torch.Generator(device=dev).manual_seed(5 + len(offs) * spec)
    shape = (L, len(offs), N_KV, BIG_S, HEAD_DIM)
    kc = (torch.randn(shape, device=dev, generator=g) * 0.4).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=g) * 0.4).bfloat16()
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=BIG_WINDOW, spec=spec, ring=ring)
    if int8:
        (kc, ks), (vc, vs) = tdsp.quantize_kv(kc), tdsp.quantize_kv(vc)
        kw.update(k_scales=ks, v_scales=vs)
    args[11], args[12] = kc, vc
    span = tdsp.attn_span(BIG_S, BIG_WINDOW, ring)
    assert tdsp.kernel_attn_plan(len(offs), N_HEADS, N_KV, spec, HEAD_DIM,
                                 span, int8)[0] > 1  # split over blocks
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    for g_, r in zip(got, ref):
        assert torch.isfinite(r.float()).all()
        assert torch.equal(g_, r), (g_.float() - r.float()).abs().max()


# Mode (f) on the cluster walk: (offsets, ring, window, int8, chunk).
# Over BIG_S = 640 slots a cluster takes up to 10 blocks of one 64-slot
# tile each (7 at a window of 400): chunks of 128 and 160 straddle the
# pieces (160 off the tiles' edges), chunks of 8 put many in one piece,
# one chunk of 640 spans the whole cluster; dead slots past the window's
# reach hold NaN.
CHUNK_CLUSTER_CASES = [
    ([600, 640], None, 400, False, 128),
    ([600, 640], None, 400, True, 160),
    ([30, 300, 660, 1500], BIG_RING, BIG_WINDOW, False, 8),
    ([30, 300, 660, 1500], BIG_RING, BIG_WINDOW, True, 8),
    ([30, 300, 660, 1500], BIG_RING, BIG_WINDOW, False, 640),
    ([30, 300, 660, 1500], BIG_RING, BIG_WINDOW, True, 640),
    ([30, 300, 660, 1500], BIG_RING, BIG_WINDOW, True, 160),
]


@pytest.mark.cuda
@pytest.mark.parametrize("offs,ring,window,int8,chunk", CHUNK_CLUSTER_CASES)
def test_decode_stack_step_chunked_cluster_kernel_matches_plain_on_card(
        inputs, offs, ring, window, int8, chunk):
    """K1 mode (f) over a long cache, split over a cluster's blocks
    (chunks across blocks, many chunks in a piece, one chunk over the
    cluster), bit-equal to the plain version (torch.equal on every
    output); the bounded cases' slots below every window are NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = list(_ring_card_args(inputs, offs, 1))
    dev = args[0].device
    g = torch.Generator(device=dev).manual_seed(7 + chunk)
    shape = (L, len(offs), N_KV, BIG_S, HEAD_DIM)
    kc = (torch.randn(shape, device=dev, generator=g) * 0.4).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=g) * 0.4).bfloat16()
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=window, ring=ring, cache_chunk=chunk)
    dead = slice(0, 128) if ring is None else None  # below 600 - 400
    if int8:
        (kc, ks), (vc, vs) = tdsp.quantize_kv(kc), tdsp.quantize_kv(vc)
        if dead is not None:
            ks[..., dead] = float("nan")
            vs[..., dead] = float("nan")
        kw.update(k_scales=ks, v_scales=vs)
    elif dead is not None:
        kc[..., dead, :] = float("nan")
        vc[..., dead, :] = float("nan")
    args[11], args[12] = kc, vc
    span = tdsp.attn_span(BIG_S, window, ring)
    assert tdsp.kernel_chunk_plan(len(offs), N_HEADS, N_KV, HEAD_DIM, span,
                                  chunk, int8)[0] > 1  # split over blocks
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    for g_, r in zip(got, ref):
        assert torch.isfinite(r.float()).all()
        assert torch.equal(g_, r), (g_.float() - r.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_chunked_block_in_rounds_matches_plain_on_card(int8):
    """The (f) attention block alone at the full width's heads over a
    head+ring cache of 131072 slots in chunks of 32768: a span longer
    than a cluster holds in one round, so the walk runs in rounds of
    chunks; bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    nh, nkv, hd, S, chunk = 32, 8, 128, 131072, 32768
    ring = (38, S - 38)
    plan = tdsp.kernel_chunk_plan(1, nh, nkv, hd, S, chunk, int8)
    assert plan[0] > 1 and plan[4] < -(-S // chunk) + 1  # rounds
    g = torch.Generator(device=dev).manual_seed(11)
    qkv = torch.randn((1, (nh + 2 * nkv) * hd), device=dev, generator=g)
    kc = (torch.randn((1, nkv, S, hd), device=dev, generator=g)
          * 0.5).bfloat16()
    vc = (torch.randn((1, nkv, S, hd), device=dev, generator=g)
          * 0.5).bfloat16()
    off = torch.tensor([S + 5000], dtype=torch.int32, device=dev)
    c, s = tdsp.rope_pair_vectors(off, hd)
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd, window=S - 2000,
              ring=ring, cache_chunk=chunk)
    if int8:
        (kc, ks), (vc, vs) = tdsp.quantize_kv(kc), tdsp.quantize_kv(vc)
        kw.update(k_scales=ks, v_scales=vs)
    got = tdsp.attention_block(qkv, c, s, kc, vc, off, **kw)
    ref = tdsp.attention_block_plain(qkv, c, s, kc, vc, off, **kw)
    torch.cuda.synchronize()
    for g_, r in zip(got, ref):
        assert torch.isfinite(r).all()
        assert torch.equal(g_, r), (g_.float() - r.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("streams,int8", [(1, False), (2, True), (8, False)])
@pytest.mark.parametrize("n_heads,n_kv,head_dim", [(32, 8, 128),
                                                   (16, 4, 128), (8, 2, 256)])
def test_chunk_plan_fits_every_admitted_chunk_on_card(
        streams, int8, n_heads, n_kv, head_dim):
    """Mode (f)'s plan (attn_step.cuh::chunk_plan) fits a block at the
    longest chunk check_geometry admits, over a cache of four such
    chunks and over the full width's grown ring, and covers the span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel library builds there")
    most = ((tdsp.SMEM_LIMIT - 8 * (tdsp.ATTN_THREADS // 32) * head_dim)
            // 4 - 4 * head_dim - 2)
    for S, chunk in ((4 * most, most), (8704, 512), (1536, 512)):
        tdsp.check_geometry(S, head_dim, None, 1, (38, S - 38),
                            cache_chunk=chunk, kv_int8=int8)
        cluster, rv, n_vg, piece, kround, nrec, smem = tdsp.kernel_chunk_plan(
            streams, n_heads, n_kv, head_dim, S, chunk, int8)
        assert cluster > 0 and smem <= tdsp.SMEM_LIMIT
        assert rv * n_vg >= n_heads // n_kv
        assert cluster * piece >= min(kround * chunk, S) and nrec >= 1
    with pytest.raises(ValueError, match="shared memory"):
        tdsp.check_geometry(4 * most + 4, head_dim, None, 1,
                            (38, 4 * most - 34), cache_chunk=most + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("streams,spec,int8", [
    (1, 1, False), (4, 1, True), (1, 8, False), (4, 8, True), (8, 8, False),
])
@pytest.mark.parametrize("n_heads,n_kv,head_dim", [(32, 8, 128),
                                                   (16, 4, 128)])
def test_cluster_plan_fits_every_admitted_span_on_card(
        streams, spec, int8, n_heads, n_kv, head_dim):
    """The library's cluster plan (attn_step.cuh::attn_plan) fits a block
    at the longest span check_geometry admits (the full width's heads,
    and K4's at tp = 2), and check_geometry refuses one slot more."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel library builds there")
    fresh = (2 if int8 else 1) * spec
    span = ((tdsp.SMEM_LIMIT - 8 * (tdsp.ATTN_THREADS // 32) * head_dim)
            // 4 - 4 * head_dim - fresh)
    tdsp.check_geometry(span, head_dim, spec=spec, kv_int8=int8)
    with pytest.raises(ValueError, match="shared memory"):
        tdsp.check_geometry(span + 1, head_dim, spec=spec, kv_int8=int8)
    cluster, rv, n_vg, piece, smem = tdsp.kernel_attn_plan(
        streams, n_heads, n_kv, spec, head_dim, span, int8)
    assert cluster > 0 and smem <= tdsp.SMEM_LIMIT
    assert rv * n_vg >= spec * n_heads // n_kv and cluster * piece >= span


# ---------------------------------------------------------------------------
# K1's chain of programmatic dependent launches and its weight stream
# ---------------------------------------------------------------------------


def _card_stacks(fmt, dev, seed=0):
    """Random fused stacks of this module's geometry in one weight format,
    made on the card: w8 codes + f32 row scales, g32 codes + f16 group
    scales, or dense bf16 (qkv and w13 in segments), with a table."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nq, nkv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=gen)

    def scales(n, k, lead=(L,)):
        if fmt == "g32":
            return (torch.rand((*lead, n, k // 32), device=dev, generator=gen)
                    * 2e-3 + 1e-4).half()
        return torch.rand((*lead, n), device=dev, generator=gen) * 4e-3 + 1e-4

    def dense(*shape):
        return (torch.randn(shape, device=dev, generator=gen) * 0.05).bfloat16()

    def norm(*shape):
        return 1 + 0.1 * torch.randn(shape, device=dev, generator=gen)

    w = {"attn_norm": norm(L, D), "ffn_norm": norm(L, D), "ada": norm(L, D),
         "final_norm": norm(D)}
    if fmt == "bf16":
        w.update(wqkv=(dense(L, nq, D), dense(L, nkv, D), dense(L, nkv, D)),
                 wo=dense(L, D, nq), w13=(dense(L, HIDDEN, D),
                                          dense(L, HIDDEN, D)),
                 w2=dense(L, D, HIDDEN), sqkv=None, so=None, s13=None,
                 s2=None, lm=dense(V, D), lm_scale=None)
        return w
    w.update(wqkv=codes(L, nq + 2 * nkv, D), sqkv=scales(nq + 2 * nkv, D),
             wo=codes(L, D, nq), so=scales(D, nq),
             w13=codes(L, 2 * HIDDEN, D), s13=scales(2 * HIDDEN, D),
             w2=codes(L, D, HIDDEN), s2=scales(D, HIDDEN),
             lm=codes(V, D), lm_scale=scales(V, D, lead=()))
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["w8", "g32", "bf16"])
@pytest.mark.parametrize("streams,spec", [(1, 1), (1, 8), (8, 8)],
                         ids=["1-row", "8-rows", "64-rows"])
@pytest.mark.parametrize("pdl", [True, False], ids=["pdl", "plain-order"])
def test_k1_launch_chain_matches_plain_on_card(fmt, streams, spec, pdl):
    """The whole step, its kernels launched as programmatic dependent
    launches (each waits for its predecessor before it touches the
    activations) or in plain stream order, bit-equal to the plain version
    in every weight format at 1, 8 and 64 rows, logits and tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    w = _card_stacks(fmt, dev, seed=streams * spec)
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (L, streams, N_KV, S + spec - 1, HEAD_DIM)
    kc = (torch.randn(shape, device=dev, generator=gen) * 0.4).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.4).bfloat16()
    x = torch.randn((streams * spec, D), device=dev, generator=gen) * 0.5
    offs = torch.arange(streams, dtype=torch.int32, device=dev) % (S - 1) + 1
    pos = (offs[:, None] + torch.arange(spec, device=dev)).reshape(-1)
    c, s = tdsp.rope_pair_vectors(pos, HEAD_DIM, device=dev)
    args = (x, offs, w["attn_norm"], w["ffn_norm"], w["ada"], w["sqkv"],
            w["so"], w["s13"], w["s2"], c, s, kc, vc, w["wqkv"], w["wo"],
            w["w13"], w["w2"], w["final_norm"], w["lm"], w["lm_scale"])
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8, spec=spec)
    old = tdsp.K1_PDL
    tdsp.K1_PDL = pdl
    try:
        got = tdsp.decode_stack_step(*args, **kw)
        tok = tdsp.decode_stack_step(*args, lm_argmax=True, **kw)[3]
        torch.cuda.synchronize()
    finally:
        tdsp.K1_PDL = old
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert torch.equal(tok, tdsp.lm_token_plain(ref[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["w8", "g32"])
@pytest.mark.parametrize("k", [256, 3072])
def test_k1_w8_g32_rows_do_not_depend_on_the_row_count_on_card(fmt, k):
    """The w8 and g32 GEMVs and folds K1 launches: row i of an M-row call
    equals its 1-row call for every M up to 8 (g32: the f64 group sums run
    in one order there), and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(k)
    n = 300
    x = torch.randint(-127, 128, (8, k), dtype=torch.int8, device=dev,
                      generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev,
                      generator=gen)
    sx = torch.rand(8, device=dev, generator=gen) * 1e-2 + 1e-4
    sc = ((torch.rand((n, k // 32), device=dev, generator=gen) * 1e-3
           + 1e-5).half() if fmt == "g32"
          else torch.rand(n, device=dev, generator=gen) * 1e-3 + 1e-5)
    ones = torch.cat([tdsp.k1_linear(x[i:i + 1], w, sc, sx[i:i + 1])
                      for i in range(8)])
    toks = torch.cat([tdsp.k1_linear(x[i:i + 1], w, sc, sx[i:i + 1],
                                     lm_argmax=True) for i in range(8)])
    torch.cuda.synchronize()
    assert torch.equal(ones, tdsp.k1_linear_plain(x, w, sc, sx))
    for m in range(1, 9):
        assert torch.equal(tdsp.k1_linear(x[:m], w, sc, sx[:m]), ones[:m])
        assert torch.equal(tdsp.k1_linear(x[:m], w, sc, sx[:m],
                                          lm_argmax=True), toks[:m])
