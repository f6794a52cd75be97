"""K7 and the one-shot per-layer route: the port against the JAX package.

K7: the same numpy inputs go through ``voxtral_tpu.ops.
decode_step_pallas.decode_layer_step`` (Pallas, interpret mode) and
``voxtral_tpu_torch.ops.decode_step.decode_layer_step`` (on the CPU: its
plain PyTorch version), one layer of the w8 stacks of
``tests/test_torch_decode_step.py`` over a position-major bf16 cache.
Tolerances as K1's there: both sides quantize the activations with the
same formula and contract int8 codes exactly; JAX sums the norms, scores,
softmax and P.V in f32, the port in f64 (rounded once), so x_out is held
to 1e-5 of its largest value and k_new / v_new, bf16 roundings of values
that agree to that order, to one bf16 ulp of their largest.

The route: the tiny w8 model of ``tests/test_torch_model.py`` (every
top-2 logit margin above 0.1, so a flip would be a fault) on JAX's
per-layer route, forced as ``tests/test_decode_megakernel.py`` forces it
(``STACK_VMEM_CAP = 1`` under ``VOXTRAL_MEGAKERNEL=force``), and on the
port's, forced by replacing ``models.voxtral.oneshot_plan``: the tokens
must be equal.  ``oneshot_plan``'s rungs are driven through
``VOXTRAL_HBM_BYTES``, the budget ``utils.hbm.check_hbm`` reads.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from tests.test_torch_decode_step import (
    D,
    EPS,
    HEAD_DIM,
    HIDDEN,
    KV_RTOL,
    L,
    N_HEADS,
    N_KV,
    S,
    X_RTOL,
    build_inputs,
)
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
from voxtral_tpu_torch import device
from voxtral_tpu_torch.models import voxtral as tvx
from voxtral_tpu_torch.ops import decode_step as tdsp
from voxtral_tpu_torch.utils import hbm

BF16 = np.dtype(ml_dtypes.bfloat16)


def to_torch(a, dev="cpu"):
    return device.to_torch(a, dev)


@pytest.fixture(scope="module")
def inputs():
    return build_inputs()


def _layer_args(inputs, rows, layer, offset, dev="cpu"):
    """(JAX args, port args) of one K7 call: ``rows`` rows, this layer's
    norms / ADA / scales, position-major caches [rows, S, Hkv, hd]."""
    params, t_embed, k_cache, v_cache, x, _, _ = inputs
    idx = np.arange(rows) % x.shape[0]
    # head-major [L, B, Hkv, S, hd] -> this layer's [rows, S, Hkv, hd]
    kc = np.ascontiguousarray(k_cache[layer][idx].transpose(0, 2, 1, 3))
    vc = np.ascontiguousarray(v_cache[layer][idx].transpose(0, 2, 1, 3))
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    jf = jdsp.fuse_decode_weights(jtree)
    ada = np.asarray(jdsp.ada_vectors(jtree, jnp.asarray(t_embed)))
    cos, sin = (np.asarray(a) for a in jdsp.rope_pair_vectors(
        jnp.asarray(offset, jnp.int32), HEAD_DIM, theta=1e6))
    per_layer = [np.asarray(jf[k])[layer] for k in
                 ("attn_norm", "ffn_norm")] + [ada[layer]] + [
        np.asarray(jf[k])[layer] for k in ("sqkv", "so", "s13", "s2")]
    stacks = [np.asarray(jf[k]) for k in ("wqkv", "wo", "w13", "w2")]
    arrays = [x[idx], *per_layer, cos, sin, kc, vc, *stacks]
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [to_torch(a, dev) for a in arrays]
    return ((jargs[0], layer, offset, *jargs[1:]),
            (targs[0], layer, offset, *targs[1:]))


KW = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("layer,offset", [(0, 5), (L - 1, S - 1)])
@pytest.mark.parametrize("rows", [1, 3])
def test_decode_layer_step_plain_matches_jax(inputs, rows, layer, offset,
                                             window):
    jargs, targs = _layer_args(inputs, rows, layer, offset)
    jx, jk, jv = jdsp.decode_layer_step(*jargs, interpret=True,
                                        window=window, **KW)
    tx, tk, tv = tdsp.decode_layer_step(*targs, window=window, **KW)
    assert tx.shape == (rows, D) and tx.dtype == torch.float32
    assert tk.shape == (rows, N_KV, HEAD_DIM) and tk.dtype == torch.bfloat16
    jx = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                               atol=X_RTOL * np.abs(jx).max())
    for got, ref in ((tk, jk), (tv, jv)):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=KV_RTOL * np.abs(ref).max())


def test_decode_layer_step_window_hides_old_slots(inputs):
    """Slots at offset - pos > window carry no weight: poisoning them
    with huge values leaves x_out as it was (JAX ``_make_kernel``'s
    ``(off - pos) <= window``)."""
    _, targs = _layer_args(inputs, 2, 1, 12)
    ref = tdsp.decode_layer_step(*targs, window=4, **KW)
    kc, vc = targs[12].clone(), targs[13].clone()
    kc[:, :8] = 1e4  # positions 0..7: 12 - 7 = 5 > 4
    vc[:, :8] = -1e4
    got = tdsp.decode_layer_step(*targs[:12], kc, vc, *targs[14:], window=4,
                                 **KW)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_decode_layer_step_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="shared memory"):
        tdsp.check_layer_geometry(10 ** 6, 128, None)
    tdsp.check_layer_geometry(8400, 128, 8192)  # the window bounds it
    assert tdsp.layer_smem_bytes(151, 128, 8192) < tdsp.layer_smem_bytes(
        8400, 128, 8192)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,window", [(1, None), (3, 4), (9, 8)])
def test_decode_layer_step_kernel_matches_plain_on_card(inputs, rows, window):
    """On the card only (the kernel has no CPU mode): bit-equal, both
    summing in f64 with FMA contraction off; 9 rows take the GEMV's
    tensor-core path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, targs = _layer_args(inputs, rows, L - 1, 12, torch.device("cuda"))
    before = tdsp.decode_layer_step.launches
    got = tdsp.decode_layer_step(*targs, window=window, **KW)
    ref = tdsp.decode_layer_step_plain(*targs, window=window, **KW)
    torch.cuda.synchronize()
    assert tdsp.decode_layer_step.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r), (g - r).abs().max().item()


# K7's split walk: spans of visible slots (with pieces of at least 64
# slots), the window's edge, a span whose scores leave shared memory.
SPLIT_PIECE = 64


@pytest.mark.parametrize("pieces", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("offset,window", [(0, None), (1, None), (65, None),
                                           (129, 100), (300, 64), (413, None),
                                           (412, 8192)])
def test_layer_attention_split_plain_equals_unsplit(offset, window, pieces):
    """The split walk's arithmetic, stated plainly, equals the unsplit
    attention bit for bit for every cut: spans 0 and 1, one past a piece
    boundary, the window's edge, the longest one-shot chunk (413)."""
    gen = torch.Generator().manual_seed(offset + pieces)
    B, S = 2, 420
    q = torch.randn((B, N_HEADS, HEAD_DIM), generator=gen)
    k = torch.randn((B, N_KV, HEAD_DIM), generator=gen)
    v = torch.randn((B, N_KV, HEAD_DIM), generator=gen)
    kc = torch.randn((B, S, N_KV, HEAD_DIM), generator=gen).bfloat16()
    vc = torch.randn((B, S, N_KV, HEAD_DIM), generator=gen).bfloat16()
    args = (q, k, v, kc, vc, offset, window, N_KV, HEAD_DIM ** -0.5)
    ref = tdsp._layer_attention_plain(*args)
    got = tdsp.layer_attention_split_plain(*args, pieces)
    assert torch.equal(got, ref)


PLAN_CASES = [(151, 150, 8192), (413, 412, 8192), (8400, 8300, 8192),
              (16, 0, None), (50000, 49999, None)]


@pytest.mark.parametrize("S,offset,window", PLAN_CASES)
def test_layer_attn_plan_covers_the_span(S, offset, window):
    """The plan's pieces cover the visible span, at most 8 of them, none
    empty but where the span is, and about K7_BLOCKS blocks a call."""
    lo = max(0, offset - window) if window is not None else 0
    n = max(min(offset, S) - lo, 0)
    for rows in (1, 8, 64):
        pieces, piece = tdsp.layer_attn_plan(S, offset, window, rows, 8)
        assert 1 <= pieces <= tdsp.K7_MAX_PIECES and pieces * piece >= n
        assert pieces == 1 or (pieces - 1) * piece < n
        assert pieces * rows * 8 <= max(tdsp.K7_BLOCKS, rows * 8)


def _card_layer(rows, S, seed, dev, F=HIDDEN):
    """Random tiny-width K7 inputs at a cache of S slots on the card:
    x, the layer's vectors and scales, RoPE at ``offset`` later, caches,
    w8 stacks of L layers (FFN width F)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nq, nkv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=gen)

    small = [1 + 0.1 * rnd(D), 1 + 0.1 * rnd(D), 1 + 0.1 * rnd(D),
             rnd(nq + 2 * nkv).abs() * 1e-3 + 1e-4,
             rnd(D).abs() * 1e-3 + 1e-4, rnd(2 * F).abs() * 1e-3 + 1e-4,
             rnd(D).abs() * 1e-3 + 1e-4]
    caches = [(rnd(rows, S, N_KV, HEAD_DIM) * 0.5).bfloat16() for _ in "kv"]
    stacks = [codes(L, nq + 2 * nkv, D), codes(L, D, nq), codes(L, 2 * F, D),
              codes(L, D, F)]
    return rnd(rows, D), small, caches, stacks


@pytest.mark.cuda
@pytest.mark.parametrize("rows,S,offset,window", [
    (1, 80, 0, None), (1, 80, 1, None), (2, 80, 65, None),
    (1, 200, 129, None), (3, 200, 193, None), (2, 300, 257, 200),
    (1, 300, 299, 64), (1, 413, 412, 8192), (3, 413, 412, 8192),
    (9, 413, 412, 8192), (8, 151, 150, 8192), (1, 2000, 1999, 1500)])
@pytest.mark.parametrize("pdl", [True, False])
def test_decode_layer_step_spans_on_card(rows, S, offset, window, pdl,
                                         monkeypatch):
    """K7 bit-equal to plain over visible spans 0 and 1, one past each
    64-slot piece boundary, the window's edge (window < offset), 3 and 9
    rows (9: the GEMV's tensor-core path) at S = 413, 8 rows, and a span
    cut into the largest cluster; with and without programmatic
    dependent launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    monkeypatch.setattr(tdsp, "K7_PIECE_SLOTS", SPLIT_PIECE)
    monkeypatch.setattr(tdsp, "K7_BLOCKS", 1024)
    monkeypatch.setattr(tdsp, "K7_PDL", pdl)
    dev = torch.device("cuda")
    x, small, (kc, vc), stacks = _card_layer(rows, S, offset + rows, dev)
    c, s = tdsp.rope_pair_vectors(offset, HEAD_DIM, 1e6, device=dev)
    args = (x, L - 1, offset, *small, c, s, kc, vc, *stacks)
    got = tdsp.decode_layer_step(*args, window=window, **KW)
    ref = tdsp.decode_layer_step_plain(*args, window=window, **KW)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), (g - r).abs().max().item()


@pytest.mark.cuda
def test_decode_layer_step_wide_ffn_on_card():
    """An FFN row wider than row_quant keeps in registers (9472 > 9216:
    its tail instantiation, which recomputes the values past them) gives
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    x, small, (kc, vc), stacks = _card_layer(2, 80, 11, dev, F=9472)
    c, s = tdsp.rope_pair_vectors(40, HEAD_DIM, 1e6, device=dev)
    args = (x, L - 1, 40, *small, c, s, kc, vc, *stacks)
    got = tdsp.decode_layer_step(*args, **KW)
    ref = tdsp.decode_layer_step_plain(*args, **KW)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), (g - r).abs().max().item()


@pytest.mark.cuda
def test_decode_layer_step_scores_in_scratch_on_card(monkeypatch):
    """A span whose scores leave a block's shared memory (the plan's
    scratch buffer) gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    # At full width (32 query heads, 8 kv heads, head_dim 128) the
    # library's layout puts a block's scores in the scratch only at the
    # longest span; at the one-shot spans they stay in shared memory.
    for S, offset, window in PLAN_CASES:
        _, piece = tdsp.layer_attn_plan(S, offset, window, 1, 8)
        assert (tdsp.layer_attn_scratch(32, 8, 128, piece) > 0) == (
            S == 50000), (S, piece)
    dev = torch.device("cuda")
    S, offset = 40000, 39990
    _, piece = tdsp.layer_attn_plan(S, offset, None, 1, N_KV)
    assert tdsp.layer_attn_scratch(N_HEADS, N_KV, HEAD_DIM, piece) > 0
    x, small, (kc, vc), stacks = _card_layer(1, S, 5, dev)
    c, s = tdsp.rope_pair_vectors(offset, HEAD_DIM, 1e6, device=dev)
    args = (x, 0, offset, *small, c, s, kc, vc, *stacks)
    got = tdsp.decode_layer_step(*args, **KW)
    ref = tdsp.decode_layer_step_plain(*args, **KW)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), (g - r).abs().max().item()


# ---------------------------------------------------------------------------
# The per-layer route and its plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def w8_tree():
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    return quantize_params_w8(dense_params(tiny_config(), SEED, SCALE,
                                           FINAL_NORM_GAIN))


def _force(monkeypatch, route):
    monkeypatch.setattr(tvx, "oneshot_plan",
                        lambda model, batch, seq_len, spec=1: (route,
                                                               "forced"))


def test_layer_route_tokens_equal_jax(w8_tree, monkeypatch):
    import voxtral_tpu.ops.decode_step_pallas as dsp
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel

    cfg = tiny_config()
    mel = test_mel()
    model = tvx.VoxtralModel.from_numpy(w8_tree, cfg, "cpu")
    stack = model.transcribe_streaming(mel)
    assert model.last_decode_route == "stack"
    _force(monkeypatch, "layer")
    model.record_margins = True
    before = tdsp.decode_layer_step.launches  # CPU: the plain version
    tokens = model.transcribe_streaming(mel)
    assert model.last_decode_route == "layer"
    assert float(model.last_margins.min()) > MIN_MARGIN
    assert len(set(tokens.tolist())) > 1
    assert tdsp.decode_layer_step.launches == before
    assert tokens.tolist() == stack.tolist()

    monkeypatch.setenv("VOXTRAL_MEGAKERNEL", "force")
    monkeypatch.setattr(dsp, "STACK_VMEM_CAP", 1)
    jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, w8_tree), cfg)
    assert np.asarray(jmodel.transcribe_streaming(mel)).tolist() == \
        tokens.tolist()


def test_layer_route_runs_speculative_as_sequential(w8_tree, monkeypatch):
    """JAX's speculative loop needs the stack kernel: on the per-layer
    route a speculative batch decodes sequentially, with the same
    tokens."""
    cfg = tiny_config()
    mel = test_mel()
    mel2 = np.concatenate([mel, mel * 0.9], axis=0)
    model = tvx.VoxtralModel.from_numpy(w8_tree, cfg, "cpu")
    ref = model.transcribe_streaming_batch(mel2)
    _force(monkeypatch, "layer")
    got = model.transcribe_streaming_batch(mel2, speculative=4)
    assert model.last_decode_route == "layer"
    assert model.last_spec_passes == 0
    assert got.tolist() == ref.tolist()


def _budget(model, batch, seq, copies):
    """A device budget admitting the weights, the workspace and
    ``copies`` one-shot caches of ``batch`` x ``seq``."""
    return int(hbm.model_hbm_bytes(model) + hbm.WORKSPACE_BYTES
               + copies * tvx.oneshot_cache_bytes(model, batch, seq))


def test_oneshot_plan_rungs(w8_tree, monkeypatch):
    cfg = tiny_config()
    model = tvx.VoxtralModel.from_numpy(w8_tree, cfg, "cpu")
    batch, seq = 4, 120
    route, why = tvx.oneshot_plan(model, batch, seq)
    assert route == "stack" and "K1" in why

    monkeypatch.setenv("VOXTRAL_HBM_BYTES",
                       str(_budget(model, batch, seq, 1.5)))
    route, why = tvx.oneshot_plan(model, batch, seq)
    assert route == "layer"
    assert why.startswith("stack (K1): ") and "head-major copy" in why
    # The speculative tail does not change the rung.
    assert tvx.oneshot_plan(model, batch, seq, spec=8)[0] == "layer"
    # One row fits both copies under the same budget.
    assert tvx.oneshot_plan(model, 1, seq)[0] == "stack"

    monkeypatch.setenv("VOXTRAL_HBM_BYTES",
                       str(_budget(model, batch, seq, 0.5)))
    with pytest.raises(hbm.HBMBudgetError) as exc:
        tvx.oneshot_plan(model, batch, seq)
    msg = str(exc.value)
    assert "stack (K1): " in msg and "layer (K7): " in msg


def test_oneshot_plan_without_k7(w8_tree, monkeypatch):
    """bf16 stacks K1 refuses take the per-op step (JAX's K7 is
    w8-only); a model without fused stacks always does."""
    cfg = tiny_config()
    dense = dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN)
    bf16 = tvx.VoxtralModel.from_numpy(
        jax.tree_util.tree_map(lambda a: a.astype(BF16), dense), cfg, "cpu")
    f32 = tvx.VoxtralModel.from_numpy(dense, cfg, "cpu")
    assert bf16.decode_route == "bf16" and f32.decode_route == "per_op"
    mel = test_mel()
    seq = bf16.decoder_seq_len(mel.shape[-1])
    route, why = tvx.oneshot_plan(f32, 1, seq)
    assert route == "per_op" and "no fused step" in why
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(_budget(bf16, 1, seq, 1.5)))
    route, why = tvx.oneshot_plan(bf16, 1, seq)
    assert route == "per_op" and why.startswith("stack (K1): ")
    tokens = bf16.transcribe_streaming(mel)
    assert bf16.last_decode_route == "per_op"
    assert len(tokens) == seq - tvx.PREFIX_LEN
    monkeypatch.delenv("VOXTRAL_HBM_BYTES")
    bf16.transcribe_streaming(mel)
    assert bf16.last_decode_route == "stack"
