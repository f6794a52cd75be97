"""K1: the port's decode stack step against the JAX stack kernel.

The same numpy inputs go through ``voxtral_tpu.ops.decode_step_pallas.
decode_stack_step`` (Pallas, interpret mode, lm fold to logits) and
``voxtral_tpu_torch.ops.decode_step.decode_stack_step`` (on the CPU: its
plain PyTorch version).  Production layout: bf16 head-major caches, w8
weights, sliding window; mode (a) a scalar offset, (b) ``spec=K`` draft
rows per stream, (c) per-stream offset vectors and per-row RoPE.

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

from voxtral_tpu.ops import decode_step_pallas as jdsp
from voxtral_tpu.ops.w8 import quantize_w8_rowwise as jax_quantize_w8
from voxtral_tpu_torch.convert import params_from_numpy
from voxtral_tpu_torch.device import to_torch
from voxtral_tpu_torch.ops import decode_step as tdsp

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


def _jax_and_port(inputs, offs, spec, window):
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
        lm_scale=jnp.asarray(lm["scale"]), interpret=True, spec=spec, **kw)
    tf = tdsp.fuse_decode_weights(params_from_numpy(params))
    got = tdsp.decode_stack_step(
        to_torch(x), torch.tensor(offs, dtype=torch.int32), tf["attn_norm"],
        tf["ffn_norm"], to_torch(np.asarray(adav)), tf["sqkv"], tf["so"],
        tf["s13"], tf["s2"], to_torch(cos), to_torch(sin), to_torch(kc),
        to_torch(vc), tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
        final_norm=to_torch(final_norm), lm_codes=to_torch(lm["codes"]),
        lm_scale=to_torch(lm["scale"]), spec=spec, **kw)
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
