"""The port's layers against ``voxtral_tpu.models.layers``, f32 and bf16.

Same numpy inputs and weights on both sides (JAX runs op by op here).
Tolerances, as a share of the output's largest value: f32 1e-5 (the
matmuls and reductions sum in another order); bf16 2**-7, one bf16 ulp
either way of a rounding the two sides may place differently (measured:
most outputs bit-equal).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from voxtral_tpu.models import layers as jl
from voxtral_tpu.utils.quantize import quantize_params_w8 as jax_quantize_w8
from voxtral_tpu_torch.models import layers as tl

TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D, H, HKV, HD, F, S = 64, 4, 2, 16, 128, 12


def _j(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][0])


def _t(a, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(DTYPES[dtype][1])


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())


def _block_params(rng, kv_heads: int, biases: bool):
    r = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    nq, nkv = H * HD, kv_heads * HD
    att = {"wq": r(D, nq), "wk": r(D, nkv), "wv": r(D, nkv), "wo": r(nq, D)}
    ffn = {"w1": r(D, F), "w2": r(F, D), "w3": r(D, F)}
    if biases:
        att.update(wq_b=r(nq), wv_b=r(nkv), wo_b=r(D))
        ffn.update(w2_b=r(D))
    p = {"attention_norm": 1 + r(D), "attention": att,
         "ffn_norm": 1 + r(D), "ffn": ffn}
    if not biases:
        p["ada"] = {"w0": r(D, 8), "w2": r(8, D)}
    return p


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(2, 5, D)) * 3, 1 + rng.normal(size=D) * 0.1
    _close(tl.rms_norm(_t(x, dtype), _t(w, dtype), 1e-5),
           jl.rms_norm(_j(x, dtype), _j(w, dtype), 1e-5), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, S, H, HD))
    pos = np.arange(3, 3 + S)
    jc, js = jl.rope_tables(HD, 64, 1e6)
    tc, ts = tl.rope_tables(HD, 64, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    _close(tl.apply_rope(_t(x, dtype), tc, ts, torch.from_numpy(pos)),
           jl.apply_rope(_j(x, dtype), jc, js, jnp.asarray(pos)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 3])
def test_attention(dtype, window):
    rng = np.random.default_rng(2)
    p = _block_params(rng, HKV, biases=True)["attention"]
    x = rng.normal(size=(2, S, D))
    spec = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, sliding_window=window)
    pos = np.arange(S)
    jc, js = jl.rope_tables(HD, S, 1e6)
    tc, ts = tl.rope_tables(HD, S, 1e6)
    ref = jl.attention(_j(x, dtype), _as(p, lambda a: _j(a, dtype)),
                       jl.AttentionSpec(**spec), jc, js, jnp.asarray(pos))
    got = tl.attention(_t(x, dtype), _as(p, lambda a: _t(a, dtype)),
                       tl.AttentionSpec(**spec), tc, ts, torch.from_numpy(pos))
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_downsample(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 128, 40))
    p = {"conv1": rng.normal(size=(D, 128, 3)) * 0.05,
         "conv1_b": rng.normal(size=D) * 0.1,
         "conv2": rng.normal(size=(D, D, 3)) * 0.05,
         "conv2_b": rng.normal(size=D) * 0.1}
    got = tl.conv_downsample(_t(x, dtype), _as(p, lambda a: _t(a, dtype)))
    assert got.shape == (1, D, 10)
    _close(got, jl.conv_downsample(_j(x, dtype), _as(p, lambda a: _j(a, dtype))),
           dtype)


def _w8(p):
    """Stack one layer as L=1 and quantize its linears with the JAX
    package's builder, then take layer 0 back out."""
    tree = jax_quantize_w8({"encoder": {"layers": _as(p, lambda a: a[None])},
                            "decoder": {}, "adapter": {}}, to_device=False)
    return _as(tree["encoder"]["layers"], lambda a: a[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["dense", "w8"])
def test_encoder_block(dtype, weights):
    rng = np.random.default_rng(4)
    p = _block_params(rng, H, biases=True)
    if weights == "w8":
        p = _w8(p)
    x = rng.normal(size=(1, S, D))
    spec = dict(n_heads=H, n_kv_heads=H, head_dim=HD, sliding_window=5)
    pos = np.arange(S)
    jc, js = jl.rope_tables(HD, S, 1e6)
    tc, ts = tl.rope_tables(HD, S, 1e6)
    jp, tp = _both(p, dtype)
    ref = jl.encoder_block(_j(x, dtype), jp, jl.AttentionSpec(**spec), jc, js,
                           jnp.asarray(pos), 1e-5)
    got = tl.encoder_block(_t(x, dtype), tp, tl.AttentionSpec(**spec), tc, ts,
                           torch.from_numpy(pos), 1e-5)
    _close(got, ref, dtype)


def _both(p, dtype):
    """(JAX tree, port tree): float leaves in ``dtype``; w8 codes and
    their f32 scales as they are (the model keeps them so)."""
    def cast(tree, to_j):
        if isinstance(tree, dict):
            if "w8" in tree:
                w = tree["w8"]
                conv = jnp.asarray if to_j else torch.from_numpy
                return {"w8": {"codes": conv(w["codes"]),
                               "scale": conv(w["scale"])}}
            return {k: cast(v, to_j) for k, v in tree.items()}
        return _j(tree, dtype) if to_j else _t(tree, dtype)

    return cast(p, True), cast(p, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 5])
def test_decoder_block_with_cache(dtype, offset):
    rng = np.random.default_rng(5)
    p = _w8(_block_params(rng, HKV, biases=False))
    max_seq, s = 16, 4
    x = rng.normal(size=(1, s, D))
    t_embed = rng.normal(size=(1, 1, D))
    kc = rng.normal(size=(1, max_seq, HKV, HD)) * (np.arange(max_seq) < offset
                                                    )[None, :, None, None]
    vc = rng.normal(size=(1, max_seq, HKV, HD)) * (np.arange(max_seq) < offset
                                                    )[None, :, None, None]
    spec = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, sliding_window=6)
    jc, js = jl.rope_tables(HD, max_seq, 1e6)
    tc, ts = tl.rope_tables(HD, max_seq, 1e6)
    jp, tp = _both(p, dtype)
    jx, jk, jv = jl.decoder_block_with_cache(
        _j(x, dtype), _j(t_embed, dtype), jp, jl.AttentionSpec(**spec), jc, js,
        _j(kc, dtype), _j(vc, dtype), jnp.asarray(offset, jnp.int32), 1e-5)
    tk, tv = _t(kc, dtype), _t(vc, dtype)
    tx, tk2, tv2 = tl.decoder_block_with_cache(
        _t(x, dtype), _t(t_embed, dtype), tp, tl.AttentionSpec(**spec), tc, ts,
        tk, tv, offset, 1e-5)
    _close(tx, jx, dtype)
    _close(tk2, jk, dtype)
    _close(tv2, jv, dtype)


def test_kv_cache_and_band_mask():
    cache = tl.KVCache.create(2, 1, 8, HKV, HD, torch.bfloat16)
    assert cache.max_seq == 8 and cache.length == 0
    bias = tl._band_mask_bias(torch.arange(4), torch.arange(6), 2, True)
    ref = jl._band_mask_bias(jnp.arange(4), jnp.arange(6), 2, True)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(ref))


def test_linear_rejects_unported_formats():
    # Dense, {"nt": w}, w8 and q4 leaves are ported; any other dict is
    # refused by name.
    with pytest.raises(ValueError, match="unknown weight format"):
        tl.linear(torch.zeros(1, 4), {"zz": torch.zeros(4, 4)})


# ---------------------------------------------------------------------------
# Head+ring caches (the unbounded stream's layout)
# ---------------------------------------------------------------------------

RING = (3, 8)  # (head, size): slots [0, 3) permanent, a ring of 8 slots


def test_ring_slot_and_k_positions_match_jax():
    """Exact, over a grid of offsets before, at and after the wraps."""
    head, size = RING
    for off in range(0, 40):
        assert tl.ring_slot(off, head, size) == int(
            jl.ring_slot(jnp.asarray(off), head, size))
        got = tl.ring_slot(torch.tensor([off, off + 1]), head, size)
        ref = jl.ring_slot(jnp.asarray([off, off + 1]), head, size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        p, valid = tl.ring_k_positions(head, size, off)
        jp, jvalid = jl.ring_k_positions(head, size, jnp.asarray(off))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        # Positions of unwritten slots are meaningless (masked): compare
        # the written ones.
        np.testing.assert_array_equal(p.numpy()[valid.numpy()],
                                      np.asarray(jp)[np.asarray(jvalid)])


def test_ring_k_positions_per_stream_and_padded():
    """Per-stream offsets [Bc, 1] give each stream's row of the scalar
    result, as the decode step reads them, and the slots a longer cache
    holds past head + size are never valid (exact)."""
    head, size = RING
    offs = [0, 2, 3, 10, 11, 12, 29, 40]
    p, valid = tl.ring_k_positions(head, size, torch.tensor(offs)[:, None],
                                   slots=head + size + 2)
    assert p.shape == valid.shape == (len(offs), head + size + 2)
    assert not valid[:, head + size:].any()
    for b, off in enumerate(offs):
        p_ref, v_ref = tl.ring_k_positions(head, size, off)
        assert valid[b, :head + size].tolist() == v_ref.tolist()
        assert (p[b, :head + size][v_ref] == p_ref[v_ref]).all()


@pytest.mark.parametrize("chunks", [[3, 1, 2, 1, 1, 2, 1, 1, 1],
                                    [3, 2, 2, 2, 2, 2, 2, 2]])
def test_attention_with_cache_ring_matches_jax(chunks):
    """Incremental writes into a head+ring cache (each write within one
    region, as the callers align them), f32: the outputs and the cache
    after every write against JAX, 1e-5 of the largest value."""
    rng = np.random.default_rng(6)
    p = _block_params(rng, HKV, biases=True)["attention"]
    spec = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, sliding_window=5)
    head, size = RING
    jc, js = jl.rope_tables(HD, 64, 1e6)
    tc, ts = tl.rope_tables(HD, 64, 1e6)
    jk = jnp.zeros((1, head + size, HKV, HD), jnp.float32)
    jv = jnp.zeros_like(jk)
    tk = torch.zeros((1, head + size, HKV, HD))
    tv = torch.zeros_like(tk)
    jp, tp = _as(p, lambda a: _j(a, "float32")), _as(p, lambda a: _t(
        a, "float32"))
    off = 0
    for n in chunks:
        x = rng.normal(size=(1, n, D))
        ref, jk, jv = jl.attention_with_cache(
            _j(x, "float32"), jp, jl.AttentionSpec(**spec), jc, js, jk, jv,
            jnp.asarray(off, jnp.int32), ring=RING)
        got, tk, tv = tl.attention_with_cache(
            _t(x, "float32"), tp, tl.AttentionSpec(**spec), tc, ts, tk, tv,
            off, ring=RING)
        _close(got, ref, "float32")
        _close(tk, jk, "float32")
        _close(tv, jv, "float32")
        off += n
    assert off > head + size  # the ring wrapped


def test_attention_with_cache_pos_base_matches_jax():
    """A bounded cache whose slot 0 sits at absolute position 10."""
    rng = np.random.default_rng(7)
    p = _block_params(rng, HKV, biases=False)["attention"]
    spec = dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, sliding_window=4)
    jc, js = jl.rope_tables(HD, 64, 1e6)
    tc, ts = tl.rope_tables(HD, 64, 1e6)
    kc = rng.normal(size=(1, S, HKV, HD)) * (np.arange(S) < 5)[
        None, :, None, None]
    x = rng.normal(size=(1, 3, D))
    ref, _, _ = jl.attention_with_cache(
        _j(x, "float32"), _as(p, lambda a: _j(a, "float32")),
        jl.AttentionSpec(**spec), jc, js, _j(kc, "float32"),
        _j(kc, "float32"), jnp.asarray(5, jnp.int32), pos_base=10)
    got, _, _ = tl.attention_with_cache(
        _t(x, "float32"), _as(p, lambda a: _t(a, "float32")),
        tl.AttentionSpec(**spec), tc, ts, _t(kc, "float32"),
        _t(kc, "float32"), 5, pos_base=10)
    _close(got, ref, "float32")
