"""Dense weights in the port: K1 mode (g) (bf16 weight segments), the
memory-neutral fuse, the ``{"nt": w}`` linear, and bf16 / f32 models end
to end (one-shot, a solo session, a B = 2 pool), against the JAX package.

K1 (g): the same numpy inputs go through JAX's ``decode_stack_step`` with
bf16 weights (Pallas, interpret mode) and the port's (on the CPU, its
plain version), in every cache mode under (g): (a) a scalar offset, (b)
``spec=K``, (c) per-stream offsets, (d) the head+ring cache, (e) the
int8 cache, (f) the chunked walk.  Tolerance: both sides cast each
linear's input row to bf16 and multiply bf16 weights exactly, but JAX
sums in f32 and the port in f64, so a row element a few f32 ulps apart
now and then rounds to the other bf16 neighbour (about 2^-16 of them
per ulp of difference, some 100 times as often as an int8 code of mode
(a) flips); the next linear's output then moves by 2^-8 of that product,
and three layers carry it on.  Measured: below 5e-7 of the largest value
where no element flips (five of the nine cases), up to 2.7e-3 (x_out,
logits, k_new, v_new) where one does; bound 1e-2 (G_RTOL), argmax
equal.  On the card, kernel and plain version both sum in f64 and are
held bit-equal at the tolerance of the other modes.

End to end: the tiny configuration of ``tests/test_torch_model.py``
(seed 9, scale 0.1, final-norm gain 6) in bf16 and in f32; every top-2
logit margin of the port's run is above 0.1, so a token flip would be a
fault, not a near-tie.  bf16 runs K1 (g) on both sides (JAX under
``VOXTRAL_MEGAKERNEL=force``); f32 runs the per-op step on both sides,
its stages held under ``scripts/compare_forward_stages.py``'s names.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from tests.test_torch_model import (
    FINAL_NORM_GAIN,
    MIN_MARGIN,
    SCALE,
    SEED,
    dense_params,
    test_mel,
    tiny_config,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from voxtral_tpu.ops import decode_step_pallas as jdsp
from voxtral_tpu_torch import convert, device
from voxtral_tpu_torch.models import layers as tl
from voxtral_tpu_torch.ops import decode_step as tdsp

BF16 = np.dtype(ml_dtypes.bfloat16)

L, B, S, D = 3, 2, 16, 256
N_HEADS, N_KV, HEAD_DIM, HIDDEN = 8, 2, 32, 512
T_COND, V = 8, 1024
EPS = 1e-5
RING = (3, 13)

G_RTOL = 1e-2      # against JAX: bf16 row roundings (module docstring)
X_RTOL = 1e-5      # kernel vs plain, of max |x_out| / |logits|
KV_RTOL = 2 ** -8  # kernel vs plain, of max |k| / |v|: one bf16 ulp


def params_from_numpy(tree, dev="cpu"):
    return convert.params_from_numpy(tree, dev)


def to_torch(a, dev="cpu"):
    return device.to_torch(a, dev)


def build_inputs():
    """numpy dense bf16 decoder params (f32 ADA and norms), t_embed,
    head-major bf16 caches, x, a bf16 lm table and its final norm."""
    rng = np.random.default_rng(7)
    nq, nkv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM

    def dense(n_in, n_out):
        return (rng.normal(size=(L, n_in, n_out)) * 0.05).astype(BF16)

    def norm(*shape):
        return (1.0 + rng.normal(size=shape) * 0.1).astype(np.float32)

    params = {"layers": {
        "ada": {"w0": (rng.normal(size=(L, D, T_COND)) * 0.05).astype(
                    np.float32),
                "w2": (rng.normal(size=(L, T_COND, D)) * 0.05).astype(
                    np.float32)},
        "attention_norm": norm(L, D),
        "attention": {"wq": dense(D, nq), "wk": dense(D, nkv),
                      "wv": dense(D, nkv), "wo": dense(nq, D)},
        "ffn_norm": norm(L, D),
        "ffn": {"w1": dense(D, HIDDEN), "w2": dense(HIDDEN, D),
                "w3": dense(D, HIDDEN)},
    }}
    t_embed = (rng.normal(size=(1, 1, D)) * 0.3).astype(np.float32)
    shape = (L, B, N_KV, S, HEAD_DIM)
    k_cache = (rng.normal(size=shape) * 0.4).astype(BF16)
    v_cache = (rng.normal(size=shape) * 0.4).astype(BF16)
    lm = (rng.normal(size=(V, D)) * 0.05).astype(BF16)
    return params, t_embed, k_cache, v_cache, lm, norm(D)


@pytest.fixture(scope="module")
def inputs():
    return build_inputs()


def _rows(inputs, offs, spec, seed=5):
    """x [Bc * spec, D] and per-row RoPE vectors at offs[b] + j, caches
    of Bc = len(offs) streams."""
    params, t_embed, k_cache, v_cache, lm, final_norm = inputs
    idx = np.arange(len(offs)) % B
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(len(offs) * spec, D)) * 0.5).astype(np.float32)
    pos = (np.asarray(offs)[:, None] + np.arange(spec)[None]).reshape(-1)
    cos, sin = jax.vmap(lambda q: jdsp.rope_pair_vectors(
        q, HEAD_DIM, theta=1e6))(jnp.asarray(pos, jnp.int32))
    return x, np.asarray(cos), np.asarray(sin), k_cache[:, idx], \
        v_cache[:, idx]


def _g_jax_and_port(inputs, offs, spec, window, ring=None, int8=False,
                    chunk=None):
    """(JAX interpret-mode outputs, port outputs) of one mode (g) step."""
    params, t_embed, _, _, lm, final_norm = inputs
    x, cos, sin, kc, vc = _rows(inputs, offs, spec)
    kc, vc = jnp.asarray(kc), jnp.asarray(vc)
    scales = {}
    if int8:
        kc, ks = jdsp.quantize_kv(kc)
        vc, vs = jdsp.quantize_kv(vc)
        scales = dict(k_scales=ks, v_scales=vs)
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    jf = jdsp.fuse_decode_weights_bf16(jtree)
    adav = jdsp.ada_vectors(jtree, jnp.asarray(t_embed))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=window, spec=spec, ring=ring, cache_chunk=chunk)
    ref = jdsp.decode_stack_step(
        jnp.asarray(x), jnp.asarray(offs, jnp.int32), jf["attn_norm"],
        jf["ffn_norm"], adav, None, None, None, None, jnp.asarray(cos),
        jnp.asarray(sin), kc, vc, jf["wqkv"], jf["wo"], jf["w13"], jf["w2"],
        final_norm=jnp.asarray(final_norm), lm_codes=jnp.asarray(lm),
        lm_scale=None, interpret=True, **scales, **kw)

    tf = tdsp.fuse_decode_weights_bf16(params_from_numpy(params))

    def cache(a):
        if a.dtype == jnp.int8:
            return to_torch(np.asarray(a))
        return to_torch(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)

    tscales = {k: to_torch(np.asarray(v)) for k, v in scales.items()}
    got = tdsp.decode_stack_step(
        to_torch(x), torch.tensor(offs, dtype=torch.int32), tf["attn_norm"],
        tf["ffn_norm"], to_torch(np.asarray(adav)), None, None, None, None,
        to_torch(cos), to_torch(sin), cache(kc), cache(vc), tf["wqkv"],
        tf["wo"], tf["w13"], tf["w2"], final_norm=to_torch(final_norm),
        lm_codes=to_torch(lm), **tscales, **kw)
    return ref, got


@pytest.mark.parametrize("offs,spec,window,ring,int8,chunk", [
    ([7, 7], 1, None, None, False, None),    # (a): one offset, no window
    ([3, 12], 1, 8, None, False, None),      # (c): the window binds
    ([5, 11], 3, 4, None, False, None),      # (b): spec rows
    ([10, 20], 1, 8, RING, False, None),     # (d): before / after the wrap
    ([14, 27], 3, 8, RING, False, None),     # (d) x (b): straddling the end
    ([0, 16], 1, 8, None, True, None),       # (e): an empty and a full cache
    ([5, 11], 3, None, None, True, None),    # (e) x (b): one requant group
    ([7, 5], 1, 8, None, False, 8),          # (f) bf16
    ([13, 9], 1, 8, (4, 8), True, 8),        # (f) x (e) x (d)
])
def test_k1_g_plain_matches_jax(inputs, offs, spec, window, ring, int8,
                                chunk):
    ref, got = _g_jax_and_port(inputs, offs, spec, window, ring, int8, chunk)
    rows = len(offs) * spec
    jx, jk, jv, jlog = ref
    tx, tk, tv, tlog = got
    assert tx.shape == (rows, D) and tlog.shape == (rows, V)
    assert tk.dtype == torch.bfloat16 and tk.shape == (L, rows, N_KV,
                                                       HEAD_DIM)
    for g, r, tol in ((tx, jx, G_RTOL), (tlog, jlog, G_RTOL),
                      (tk, jk, G_RTOL), (tv, jv, G_RTOL)):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max())
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                  np.asarray(jlog).argmax(-1))


def test_k1_g_guards(inputs):
    """The JAX wrapper's guards that apply to mode (g): the lm table's
    dtype follows the weights', spec + chunked is refused; segments
    must make up their stack."""
    params, _, k_cache, v_cache, lm, final_norm = inputs
    tf = tdsp.fuse_decode_weights_bf16(params_from_numpy(params))
    c, s = tdsp.rope_pair_vectors(3, HEAD_DIM)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS)

    def step(wqkv=tf["wqkv"], lm_codes=to_torch(lm), rows=B, **over):
        return tdsp.decode_stack_step(
            torch.zeros((rows, D)), 3, tf["attn_norm"], tf["ffn_norm"],
            torch.ones((L, D)), None, None, None, None, c, s,
            to_torch(k_cache), to_torch(v_cache), wqkv, tf["wo"], tf["w13"],
            tf["w2"], final_norm=to_torch(final_norm), lm_codes=lm_codes,
            **dict(kw, **over))

    with pytest.raises(ValueError, match="must match the weight mode"):
        step(lm_codes=torch.zeros((V, D), dtype=torch.int8),
             lm_scale=torch.ones(V))
    with pytest.raises(ValueError, match="cache_chunk unsupported"):
        step(rows=2 * B, spec=2, cache_chunk=8)
    with pytest.raises(ValueError, match="bf16 stacks"):
        step(wqkv=(tf["wqkv"][0], tf["wqkv"][1].float(), tf["wqkv"][2]))
    out = step()
    assert len(out) == 4 and out[3].shape == (B, V)
    # One concatenated qkv stack computes what the segments do.
    cat = torch.cat(tf["wqkv"], dim=1)
    for a, b in zip(step(wqkv=cat), out):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec,ring,int8,chunk", [
    ([7, 7], 1, None, False, None),            # (g): 2 rows
    ([3, 12, 0, 16], 1, None, False, None),    # (g) x (c)
    ([5, 11], 3, None, False, None),           # (g) x (b): 6 rows
    ([2, 7, 9, 13], 4, None, False, None),     # 16 rows: two row passes
    ([1, 3, 4, 6, 8, 10, 12, 14], 8, None, False, None),  # 64 rows
    ([10, 20, 40, 14], 1, RING, False, None),  # (g) x (d)
    ([14, 27], 3, RING, True, None),           # (g) x (d) x (e) x (b)
    ([7, 5], 1, None, True, 8),                # (g) x (f) x (e)
    ([13, 9], 1, (4, 8), False, 8),            # (g) x (f), ring padded
])
def test_k1_g_kernel_matches_plain_on_card(inputs, offs, spec, ring, int8,
                                           chunk):
    """Runs on the card only (the kernel has no CPU mode): bit-equal to
    the plain version (f64 sums rounded once, no FMA contraction), held
    under the tolerance above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    params, t_embed, _, _, lm, final_norm = inputs
    x, cos, sin, kc, vc = _rows(inputs, offs, spec, seed=31)
    tp = params_from_numpy(params, dev)
    tf = tdsp.fuse_decode_weights_bf16(tp)
    kc = to_torch(kc, dev)
    vc = to_torch(vc, dev)
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=8, spec=spec, ring=ring, cache_chunk=chunk)
    if int8:
        (kc, ks), (vc, vs) = tdsp.quantize_kv(kc), tdsp.quantize_kv(vc)
        kw.update(k_scales=ks, v_scales=vs)
    args = (to_torch(x, dev), torch.tensor(offs, dtype=torch.int32,
                                           device=dev),
            tf["attn_norm"], tf["ffn_norm"],
            tdsp.ada_vectors(tp, to_torch(t_embed, dev)), None, None, None,
            None, to_torch(cos, dev), to_torch(sin, dev), kc, vc,
            tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
            to_torch(final_norm, dev), to_torch(lm, dev))
    before = tdsp.decode_stack_step.launches
    got = tdsp.decode_stack_step(*args, **kw)
    ref = tdsp.decode_stack_step_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tdsp.decode_stack_step.launches == before + 1
    for g, r in zip(got, ref):
        r = r.float()
        torch.testing.assert_close(g.float(), r, rtol=0,
                                   atol=max(X_RTOL, KV_RTOL if g.dtype
                                            == torch.bfloat16 else 0)
                                   * r.abs().max().item())
    assert torch.equal(got[3].argmax(-1), ref[3].argmax(-1))


# ---------------------------------------------------------------------------
# The fuse, the linear, the route
# ---------------------------------------------------------------------------


def _trees():
    """numpy decoder trees of each weight format, from one dense tree."""
    from voxtral_tpu.utils.quantize import quantize_params_q4
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    dense = dense_params(tiny_config(), SEED, SCALE)
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(BF16), dense)
    q4g = quantize_params_q4(dense, to_device=False, pack=False)
    q4 = quantize_params_q4(dense, to_device=False, pack=True)
    return {"w8": quantize_params_w8(dense), "q4g": q4g, "q4": q4,
            "bf16": bf16, "f32": dense}


def test_megakernel_mode_matches_jax():
    cfg = tiny_config()
    hd = cfg.language_model.head_dim
    # q4g: the tiny widths (64) are not the multiples of 128 mode (h)
    # needs, so both packages route it to the per-op step.
    want = {"w8": "w8", "q4g": None, "q4": None, "bf16": "bf16",
            "f32": None}
    for name, tree in _trees().items():
        jmode = jdsp.megakernel_mode(
            jax.tree_util.tree_map(jnp.asarray, tree["decoder"]), hd)
        tmode = tdsp.megakernel_mode(params_from_numpy(tree["decoder"]), hd)
        assert tmode == jmode == want[name], name
    # After the rewrite the {"nt": w} leaves still read as "bf16".
    dec = params_from_numpy(_trees()["bf16"]["decoder"])
    tdsp.fuse_decode_weights_bf16(dec)
    assert tdsp.megakernel_mode(dec, hd) == "bf16"


def test_fuse_bf16_is_memory_neutral(inputs):
    """The fused stacks are the {"nt": w} leaves themselves (the same
    storage), the originals are gone from the tree, a second fuse adds
    nothing, and the values are JAX's."""
    from voxtral_tpu_torch.utils.hbm import tree_unique_bytes

    params = inputs[0]
    dec = params_from_numpy(params)
    before = tree_unique_bytes(dec)
    fused = tdsp.fuse_decode_weights_bf16(dec)
    att, ffn = dec["layers"]["attention"], dec["layers"]["ffn"]
    pairs = [(fused["wqkv"][0], att["wq"]), (fused["wqkv"][1], att["wk"]),
             (fused["wqkv"][2], att["wv"]), (fused["wo"], att["wo"]),
             (fused["w13"][0], ffn["w1"]), (fused["w13"][1], ffn["w3"]),
             (fused["w2"], ffn["w2"])]
    for f, leaf in pairs:
        assert set(leaf) == {"nt"}
        assert (f.untyped_storage().data_ptr()
                == leaf["nt"].untyped_storage().data_ptr())
    assert fused["sqkv"] is fused["so"] is fused["s13"] is fused["s2"] is None
    assert tree_unique_bytes(dec, fused) == before
    again = tdsp.fuse_decode_weights_bf16(dec)
    assert all(a is b for a, b in zip(again["wqkv"], fused["wqkv"]))
    jf = jdsp.fuse_decode_weights_bf16(
        jax.tree_util.tree_map(jnp.asarray, params))
    for name in ("wqkv", "w13"):
        for a, b in zip(fused[name], jf[name]):
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    for name in ("wo", "w2", "attn_norm", "ffn_norm"):
        np.testing.assert_array_equal(
            fused[name].float().numpy(),
            np.asarray(jf[name].astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nt_linear_matches_dense_and_jax(dtype):
    """{"nt": w} contracts the [out, in] layout as the dense [in, out]
    leaf does (bit-equal), and both agree with JAX's linear to one ulp
    of the output dtype (f32 summation order)."""
    from voxtral_tpu.models.layers import linear as jlinear

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(48,)) * 0.1).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    tw = torch.from_numpy(w).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -22
    for bias in (None, torch.from_numpy(b).to(dtype)):
        dense = tl.linear(tx, tw, bias)
        nt = tl.linear(tx, {"nt": tw.T.contiguous()}, bias)
        assert dense.dtype == dtype and torch.equal(dense, nt)
        ref = jlinear(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                      None if bias is None else jnp.asarray(b, jdt))
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(dense.float().numpy(), ref, rtol=0,
                                   atol=ulp * np.abs(ref).max())


# ---------------------------------------------------------------------------
# End to end against the JAX package
# ---------------------------------------------------------------------------


def _tree(dtype: str) -> dict:
    tree = dense_params(tiny_config(), SEED, SCALE, FINAL_NORM_GAIN)
    if dtype == "bf16":
        tree = jax.tree_util.tree_map(lambda a: a.astype(BF16), tree)
    return tree


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's tokens: bf16 through its fused step (Pallas interpret mode),
    f32 through its XLA step, each the sequential one-shot run."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for dtype, env in (("bf16", "force"), ("f32", "0")):
            mp.setenv("VOXTRAL_MEGAKERNEL", env)
            model = JaxModel(
                jax.tree_util.tree_map(jnp.asarray, _tree(dtype)),
                tiny_config())
            assert model.megakernel_weights == (
                "bf16" if dtype == "bf16" else None)
            out[dtype] = np.asarray(model.transcribe_streaming(test_mel()))
    return out


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_one_shot_tokens_equal_jax(dtype, jax_runs):
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    model = VoxtralModel.from_numpy(_tree(dtype), tiny_config(), "cpu")
    assert model.decode_route == ("bf16" if dtype == "bf16" else "per_op")
    want_dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert model.compute_dtype == model.cache_dtype == want_dt
    model.record_margins = True
    tokens = model.transcribe_streaming(test_mel())
    assert len(set(tokens.tolist())) > 1
    assert float(model.last_margins.min()) > MIN_MARGIN
    assert tokens.tolist() == jax_runs[dtype].tolist()
    if dtype == "bf16":  # speculative and batched rows on mode (g)
        for draft in ("ngram", "pad"):
            spec = model.transcribe_streaming(test_mel(), speculative=4,
                                              draft=draft)
            assert spec.tolist() == tokens.tolist()
        mel = test_mel()
        batch = model.transcribe_streaming_batch(
            np.concatenate([mel, mel]), speculative=3)
        assert (batch == tokens[None]).all()


def test_f32_forward_stages_match_jax():
    """The f32 model's stages (``scripts/compare_forward_stages.py``'s
    names), each fed JAX's previous stage.  f32 end to end: summation
    order only, 1e-5 of the stage's largest value (measured below
    2e-6)."""
    from voxtral_tpu.models import adapter as ja, decoder as jd, encoder as je
    from voxtral_tpu.models import layers as jl
    from voxtral_tpu.models.voxtral import make_prefix_ids
    from voxtral_tpu_torch.models import adapter as ta, decoder as td
    from voxtral_tpu_torch.models import encoder as te
    from voxtral_tpu_torch.models.time_embedding import time_embedding

    cfg = tiny_config()
    ecfg, lcfg = cfg.audio_encoder, cfg.language_model
    tree = _tree("f32")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree)
    jmel = jnp.asarray(test_mel())

    def t(a):
        return torch.from_numpy(np.array(a))

    def check(name, got, ref, tol=1e-5):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == np.float32, name
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= tol, f"stage {name}: {err:.3e} of max > {tol}"

    j_conv = jl.conv_downsample(jmel, jp["encoder"]["conv"])
    check("conv", tl.conv_downsample(t(jmel), tp["encoder"]["conv"]), j_conv)
    j_enc = je.encoder_forward(jp["encoder"], jmel, ecfg)
    check("encoder", te.encoder_forward(tp["encoder"], t(jmel), ecfg), j_enc)
    j_ad = ja.adapter_forward(jp["adapter"], ja.reshape_encoder_output(j_enc))
    check("adapter", ta.adapter_forward(
        tp["adapter"], ta.reshape_encoder_output(t(j_enc))), j_ad)
    ids = make_prefix_ids()[None]
    j_in = j_ad[:, :38] + jd.embed_tokens(jp["decoder"], jnp.asarray(ids))
    t_emb = time_embedding(6.0, lcfg.dim)
    n = j_ad.shape[1]
    spec = jd.decoder_spec(lcfg)
    cos, sin = jl.rope_tables(lcfg.head_dim, n, lcfg.rope_theta)
    jc = jd.create_cache(lcfg, 1, n, jnp.float32)
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jp["decoder"]["layers"])
    j_l0, _, _ = jl.decoder_block_with_cache(
        j_in, jnp.asarray(t_emb), lp0, spec, cos, sin, jc.k[0], jc.v[0],
        jnp.asarray(0, jnp.int32), lcfg.norm_eps)
    tc = td.create_cache(lcfg, 1, n, torch.float32)
    tcos, tsin = tl.rope_tables(lcfg.head_dim, n, lcfg.rope_theta)
    t_l0, _, _ = tl.decoder_block_with_cache(
        t(j_in), t(t_emb), tl.layer_params(tp["decoder"]["layers"], 0),
        td.decoder_spec(lcfg), tcos, tsin, tc.k[0], tc.v[0], 0,
        lcfg.norm_eps)
    check("decoder_layer0", t_l0, j_l0)
    j_hid, _ = jd.decoder_forward_hidden_with_cache(
        jp["decoder"], j_in, jnp.asarray(t_emb),
        jd.create_cache(lcfg, 1, n, jnp.float32), lcfg)
    t_hid, _ = td.decoder_forward_hidden_with_cache(
        tp["decoder"], t(j_in), t(t_emb),
        td.create_cache(lcfg, 1, n, torch.float32), lcfg)
    check("final_hidden", t_hid, j_hid)
    check("logits_last", td.lm_head(tp["decoder"], t(j_hid)[:, -1]),
          jd.lm_head(jp["decoder"], j_hid[:, -1]))


def _noise(secs: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=int(secs * 16000))
            * 0.25).astype(np.float32)


# The tiny models sit on near-ties for much noise (a margin of 0.01 in
# one seed of three): these two give the port's bf16 and f32 sessions
# margins above 0.3 (the test asserts 0.1).
SESSION_SIGNALS = (_noise(4.0, 7), _noise(3.0, 13))


def _pool_pair(Session, Pool, model):
    """Both signals as two streams of one B = 2 bounded pool -> tokens."""
    pool = Pool(model, max_streams=2, step_positions=8, max_duration_s=20)
    a = Session(model, step_positions=8, pool=pool)
    b = Session(model, step_positions=8, pool=pool)
    a.feed(SESSION_SIGNALS[0])
    b.feed(SESSION_SIGNALS[1])
    a.finish()
    b.finish()
    return pool, [list(a.tokens), list(b.tokens)]


def test_bf16_session_and_pool_match_jax():
    """Bounded bf16 sessions (K1 (g)) and a B = 2 bf16 pool (K1 (g) x
    (c)) give JAX's session tokens (JAX's own bf16 test holds its fused
    session equal to its XLA one, which runs here for speed); f32
    sessions (the per-op step, f32 caches) give JAX's f32 sessions', and
    a B = 2 f32 pool (the generic pool, slot by slot on the per-op step,
    f32 caches) JAX's f32 pool's."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.streaming import StreamingSession as JaxSession
    from voxtral_tpu.streaming import StreamPool as JaxPool
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

    cfg = tiny_config()
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "0")
        for dtype in ("bf16", "f32"):
            jm = JaxModel(jax.tree_util.tree_map(jnp.asarray, _tree(dtype)),
                          cfg)
            ref[dtype] = []
            for sig in SESSION_SIGNALS:
                js = JaxSession(jm, step_positions=8, max_duration_s=20)
                js.feed(sig)
                js.finish()
                ref[dtype].append(list(js.tokens))
        jpool, ref["f32_pool"] = _pool_pair(JaxSession, JaxPool, jm)
        assert jpool.dec_k.dtype == jnp.float32
    assert len(set(ref["bf16"][0])) > 1
    for dtype in ("bf16", "f32"):
        model = VoxtralModel.from_numpy(_tree(dtype), cfg, "cpu")
        model.record_margins = True
        for sig, want in zip(SESSION_SIGNALS, ref[dtype]):
            ses = StreamingSession(model, step_positions=8,
                                   max_duration_s=20)
            ses.feed(sig)
            ses.finish()
            assert ses.dec_cache.k.dtype == model.cache_dtype
            assert min(ses.margins) > MIN_MARGIN
            assert ses.tokens == want, dtype
        if dtype == "f32":
            pool, got = _pool_pair(StreamingSession, StreamPool, model)
            assert pool._fused is None
            assert pool.dec_k.dtype == torch.float32
            assert got == ref["f32_pool"]
    model = VoxtralModel.from_numpy(_tree("bf16"), cfg, "cpu")
    pool, got = _pool_pair(StreamingSession, StreamPool, model)
    assert pool._fused is not None and pool.dec_k.dtype == torch.bfloat16
    assert got == ref["bf16"]


def test_bf16_speculative_session_gives_the_sequential_tokens():
    """A bf16 session with speculative=4 (K1 (g) x (b), the offset on
    the device as mode (c)) gives the sequential session's tokens in
    fewer passes, on both draft policies."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.streaming import StreamingSession

    model = VoxtralModel.from_numpy(_tree("bf16"), tiny_config(), "cpu")
    seq = StreamingSession(model, step_positions=8, unbounded=True)
    seq.feed(SESSION_SIGNALS[0])
    seq.finish()
    for draft in ("pad", "ngram"):
        ses = StreamingSession(model, step_positions=8, unbounded=True,
                               speculative=4, draft=draft)
        ses.feed(SESSION_SIGNALS[0])
        ses.finish()
        assert ses.tokens == seq.tokens, draft
        assert ses.spec_metrics()["passes"] >= 1


# ---------------------------------------------------------------------------
# K1's weight stream on the card (csrc/k1_stream.cuh)
# ---------------------------------------------------------------------------

STREAM_ROWS = (1, 2, 8, 12, 64)


def _card_bf16(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).bfloat16().to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(200, 3072), (96, 4096), (64, 9216),
                                 (48, 256)])
def test_k1_bf16_rows_do_not_depend_on_the_row_count_on_card(n, k):
    """Mode (g)'s GEMV on the card: row i of an M-row call equals its
    1-row call bit for bit for M in {1, 2, 8, 12, 64} (one row takes
    bf16_row_dots, more the f64 tensor cores), each equal to the plain
    version; a ragged last group (n % 16 != 0) included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + k)
    x = _card_bf16(rng, dev, 64, k)
    w = _card_bf16(rng, dev, n, k, scale=0.02)
    ones = torch.cat([tdsp.k1_linear(x[i:i + 1], w) for i in range(64)])
    torch.cuda.synchronize()
    assert torch.equal(ones, tdsp.bf16_matmul_plain(x, w))
    for m in STREAM_ROWS:
        assert torch.equal(tdsp.k1_linear(x[:m], w), ones[:m]), m


@pytest.mark.cuda
@pytest.mark.parametrize("k,offset", [(100, 0), (3072, 1), (264, 3)],
                         ids=["k%8", "unaligned", "unaligned-k%128"])
@pytest.mark.parametrize("m", [1, 8])
def test_k1_bf16_odd_shapes_match_plain_on_card(k, offset, m):
    """bf16 shapes the stream does not take (K % 8 != 0, rows that are not
    16-byte aligned) go to bf16_row_dots and still equal the plain
    version, as GEMV and as fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(k + m)
    x = _card_bf16(rng, dev, m, k)
    w = _card_bf16(rng, dev, 70 * k + offset, 1, scale=0.02)
    w = w.reshape(-1)[offset:].reshape(70, k)  # rows offset from 16 bytes
    got = tdsp.k1_linear(x, w)
    tok = tdsp.k1_linear(x, w, lm_argmax=True)
    torch.cuda.synchronize()
    assert torch.equal(got, tdsp.bf16_matmul_plain(x, w))
    assert torch.equal(tok, tdsp.lm_token_plain(got))
