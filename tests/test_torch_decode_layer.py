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
