"""K1 (a): the whole single-token decode step, hand-written CUDA for Hopper.

Replaces ``voxtral_tpu/ops/decode_step_pallas.py::decode_stack_step``
(kernel body ``_make_stack_kernel``) in its mode (a): w8 weights, bf16
bounded head-major cache, scalar offset, sliding window, final norm +
tied lm_head folded into logits.  Source: ``csrc/decode_step.cu``.

What bounds it on the H100: the int8 weights streamed once per step —
26 layers of wqkv / wo / w13 / w2 plus the 131072 x 3072 lm table, about
3.4 GB at full width.  The simple design: a fixed sequence of kernels on
the current stream (row norm + int8 quant, W8A8 GEMV with 16-byte loads
and ``__dp4a``, one RoPE + GQA attention block per (row, query head),
residual adds fused into the GEMV epilogue) — 9 launches per layer + 2,
no cross-block carry.  One call of the wrapper is one step and counts as
one launch in ``decode_stack_step.launches``.

Also here, the host-side preparation the JAX module holds beside the
kernel: :func:`fuse_decode_weights`, :func:`ada_vectors` and
:func:`rope_pair_vectors`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from voxtral_tpu_torch.ops._build import check, kernel_fn
from voxtral_tpu_torch.ops.w8 import quantize_activations as _quant
from voxtral_tpu_torch.ops.w8_kernel import w8_matmul_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

Params = dict


def fuse_decode_weights(decoder_params: Params) -> Params:
    """The step's fused stacks from w8 decoder params.

    wqkv [L, Nq + 2 Nkv, D], wo [L, D, Nq], w13 [L, 2F, D], w2 [L, D, F]
    int8 with f32 row-scale stacks, and f32 norm stacks [L, D].
    """
    lyr = decoder_params["layers"]
    att, ffn = lyr["attention"], lyr["ffn"]

    def codes(leaf):
        return leaf["w8"]["codes"]

    def scales(leaf):
        return leaf["w8"]["scale"].float()

    return {
        "wqkv": torch.cat([codes(att["wq"]), codes(att["wk"]),
                           codes(att["wv"])], dim=1),
        "sqkv": torch.cat([scales(att["wq"]), scales(att["wk"]),
                           scales(att["wv"])], dim=1),
        "wo": codes(att["wo"]).contiguous(), "so": scales(att["wo"]),
        "w13": torch.cat([codes(ffn["w1"]), codes(ffn["w3"])], dim=1),
        "s13": torch.cat([scales(ffn["w1"]), scales(ffn["w3"])], dim=1),
        "w2": codes(ffn["w2"]).contiguous(), "s2": scales(ffn["w2"]),
        "attn_norm": lyr["attention_norm"].float(),
        "ffn_norm": lyr["ffn_norm"].float(),
    }


def ada_vectors(decoder_params: Params, t_embed: torch.Tensor,
                mm=None) -> torch.Tensor:
    """Per-layer ADA modulation vectors 1 + w2(gelu(w0 t)) -> [L, D] f32.

    ``t_embed`` [1, 1, D]; computed once per transcription in f32 (the
    JAX reference vmaps the same per-layer function).  ``mm`` as in
    :func:`voxtral_tpu_torch.ops.w8.w8_matmul`.
    """
    from voxtral_tpu_torch.models.layers import layer_params, linear, n_stacked

    ada = decoder_params["layers"]["ada"]
    t = t_embed[0].float()
    out = []
    for l in range(n_stacked(ada)):
        p = layer_params(ada, l)
        h = linear(t, p["w0"], mm=mm)
        h = torch.nn.functional.gelu(h.float(), approximate="none")
        out.append(1.0 + linear(h, p["w2"], mm=mm)[0].float())
    return torch.stack(out)


def rope_pair_vectors(position, head_dim: int, theta: float = 1_000_000.0,
                      device=None):
    """C/S vectors of the adjacent-pair RoPE at ``position`` (int or
    int tensor of any shape) -> (c, s) [..., hd] f32 with
    c[2i] = c[2i+1] = cos(p f_i), s[2i] = -sin(p f_i), s[2i+1] = sin(p f_i).
    """
    half = head_dim // 2
    pos = torch.as_tensor(position, device=device).float()
    inv_freq = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=pos.device) * 2.0
        / head_dim))
    ang = pos[..., None] * inv_freq
    c = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)
    sn = torch.sin(ang)
    s = torch.stack([-sn, sn], dim=-1).reshape(*ang.shape[:-1], head_dim)
    return c, s


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _rope_swap(v: torch.Tensor) -> torch.Tensor:
    """Adjacent-lane swap [..., 2i] <-> [..., 2i+1]."""
    return v.reshape(*v.shape[:-1], -1, 2).flip(-1).reshape(v.shape)


def _sum64(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in f64, rounded once to f32."""
    return t.double().sum(dim=-1).float()


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """(x * (1 / sqrt(mean(x^2) + eps))) * w, mean(x^2) in f64."""
    xd = x.double()
    var = ((xd * xd).sum(dim=-1, keepdim=True) / x.shape[-1]).float()
    return x * (1.0 / torch.sqrt(var + eps)) * w


def decode_stack_step_plain(
    x, offset: int,
    attn_norms, ffn_norms, ada_vecs,
    sqkv, so, s13, s2, cos_p, sin_p,
    k_cache, v_cache,
    wqkv, wo, w13, w2,
    final_norm=None, lm_codes=None, lm_scale=None,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None,
):
    """Plain PyTorch version of the kernel, step by step as the JAX
    kernel computes it.  Returns (x_out [B, D] f32, k_new, v_new
    [L, B, Hkv, hd] cache dtype[, logits [B, V] f32]).

    Float reductions (sum of squares, scores, softmax sum, P.V) run in
    f64 and round once to f32, as the CUDA kernel does: both agree bit
    for bit whatever order each sums in.
    """
    B, D = x.shape
    L, _, _, S, _ = k_cache.shape
    nq, nkv = n_heads * head_dim, n_kv * head_dim
    groups = n_heads // n_kv
    scale = head_dim ** -0.5
    hidden = w2.shape[2]
    c, s = cos_p.float(), sin_p.float()
    pos = torch.arange(S, device=x.device)
    valid = pos < offset
    if window is not None:
        valid &= (offset - pos) <= window
    x = x.float()
    k_new, v_new = [], []
    for l in range(L):
        h = _rms(x, attn_norms[l].float(), eps)
        qkv = w8_matmul_plain(*_quant(h), wqkv[l], sqkv[l])
        q = qkv[:, :nq].reshape(B, n_heads, head_dim)
        k = qkv[:, nq:nq + nkv].reshape(B, n_kv, head_dim)
        v = qkv[:, nq + nkv:].reshape(B, n_kv, head_dim)
        q = q * c + _rope_swap(q) * s
        k = k * c + _rope_swap(k) * s
        k_new.append(k.to(k_cache.dtype))
        v_new.append(v.to(v_cache.dtype))

        qg = q.reshape(B * n_kv, groups, head_dim) * scale
        kc = k_cache[l].reshape(B * n_kv, S, head_dim).double()
        vc = v_cache[l].reshape(B * n_kv, S, head_dim).double()
        scores = (qg.to(k_cache.dtype).double() @ kc.transpose(1, 2)).float()
        scores = torch.where(valid, scores, float("-inf"))
        self_s = _sum64(qg.double() * k.reshape(B * n_kv, 1, head_dim).double())
        m = torch.maximum(scores.amax(-1), self_s)
        e_cache = torch.exp(scores - m[..., None])
        e_self = torch.exp(self_s - m)
        denom = _sum64(e_cache) + e_self
        ctx = (e_cache.to(v_cache.dtype).double() @ vc).float()
        ctx = ctx + e_self[..., None] * v.reshape(B * n_kv, 1, head_dim)
        attn = (ctx / denom[..., None]).reshape(B, nq)
        x = x + w8_matmul_plain(*_quant(attn), wo[l], so[l])

        h = _rms(x, ffn_norms[l].float(), eps) * ada_vecs[l].float()
        up = w8_matmul_plain(*_quant(h), w13[l], s13[l])
        gate, upv = up[:, :hidden], up[:, hidden:]
        hmid = gate * (1.0 / (1.0 + torch.exp(-gate))) * upv
        x = x + w8_matmul_plain(*_quant(hmid), w2[l], s2[l])
    out = (x, torch.stack(k_new), torch.stack(v_new))
    if lm_codes is None:
        return out
    h = _rms(x, final_norm.float(), eps)
    return (*out, w8_matmul_plain(*_quant(h), lm_codes, lm_scale))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_stack_step: {msg}")


def decode_stack_step(
    x, offset: int,
    attn_norms, ffn_norms, ada_vecs,
    sqkv, so, s13, s2, cos_p, sin_p,
    k_cache, v_cache,
    wqkv, wo, w13, w2,
    final_norm=None, lm_codes=None, lm_scale=None,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None,
):
    """All decoder layers of one single-token step (+ lm fold).

    x [B, D] f32; ``offset`` int = cache slots already written (the
    query's position); caches head-major [L, B, Hkv, S, hd] bf16 (read
    at slots < offset only); fused w8 stacks from
    :func:`fuse_decode_weights`; ``window`` = sliding window (None: no
    lower bound).  Returns (x_out, k_new, v_new[, logits]) like
    :func:`decode_stack_step_plain`; the caller appends k_new / v_new.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    or raise.
    """
    args = (x, offset, attn_norms, ffn_norms, ada_vecs, sqkv, so, s13, s2,
            cos_p, sin_p, k_cache, v_cache, wqkv, wo, w13, w2,
            final_norm, lm_codes, lm_scale)
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps,
              window=window)
    dev = x.device
    if dev.type == "cpu":
        return decode_stack_step_plain(*args, **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"decode_stack_step: unsupported device {dev}")

    B, D = x.shape
    L, Bc, Hkv, S, hd = k_cache.shape
    nq, nkvd = n_heads * head_dim, n_kv * head_dim
    F = w2.shape[2]
    _require(isinstance(offset, int) and 0 <= offset <= S,
             f"offset must be an int in [0, {S}], got {offset!r}")
    _require(Bc == B and Hkv == n_kv and hd == head_dim,
             f"cache {tuple(k_cache.shape)} does not match B={B}, "
             f"n_kv={n_kv}, head_dim={head_dim}")
    _require(head_dim % 2 == 0 and head_dim <= 256 and n_heads % n_kv == 0,
             "head_dim must be even and <= 256, n_kv must divide n_heads")
    expect = {
        "x": (x, torch.float32, (B, D)),
        "attn_norms": (attn_norms, torch.float32, (L, D)),
        "ffn_norms": (ffn_norms, torch.float32, (L, D)),
        "ada_vecs": (ada_vecs, torch.float32, (L, D)),
        "sqkv": (sqkv, torch.float32, (L, nq + 2 * nkvd)),
        "so": (so, torch.float32, (L, D)),
        "s13": (s13, torch.float32, (L, 2 * F)),
        "s2": (s2, torch.float32, (L, D)),
        "cos_p": (cos_p, torch.float32, (head_dim,)),
        "sin_p": (sin_p, torch.float32, (head_dim,)),
        "k_cache": (k_cache, torch.bfloat16, (L, B, n_kv, S, head_dim)),
        "v_cache": (v_cache, torch.bfloat16, (L, B, n_kv, S, head_dim)),
        "wqkv": (wqkv, torch.int8, (L, nq + 2 * nkvd, D)),
        "wo": (wo, torch.int8, (L, D, nq)),
        "w13": (w13, torch.int8, (L, 2 * F, D)),
        "w2": (w2, torch.int8, (L, D, F)),
    }
    V = 0
    if lm_codes is not None:
        V = lm_codes.shape[0]
        expect["final_norm"] = (final_norm, torch.float32, (D,))
        expect["lm_codes"] = (lm_codes, torch.int8, (V, D))
        expect["lm_scale"] = (lm_scale, torch.float32, (V,))
    for name, (t, dtype, shape) in expect.items():
        _require(t is not None and t.dtype == dtype
                 and tuple(t.shape) == shape,
                 f"{name} must be {dtype} {shape}, got "
                 f"{None if t is None else (t.dtype, tuple(t.shape))}")
        _require(t.device == dev and t.is_contiguous(),
                 f"{name} must be contiguous on {dev}")

    f32 = dict(dtype=torch.float32, device=dev)
    x_out = torch.empty((B, D), **f32)
    k_new = torch.empty((L, B, n_kv, head_dim), dtype=torch.bfloat16,
                        device=dev)
    v_new = torch.empty_like(k_new)
    logits = torch.empty((B, V), **f32) if V else None
    xq_buf = torch.empty((B, max(D, nq, F)), dtype=torch.int8, device=dev)
    sx_buf = torch.empty((B,), **f32)
    qkv_buf = torch.empty((B, nq + 2 * nkvd), **f32)
    attn_buf = torch.empty((B, nq), **f32)
    up_buf = torch.empty((B, 2 * F), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = kernel_fn("vx_decode_stack_step", [_P] * 28 + [_I] * 11
                   + [_F, _F, _P])
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(
        ptr(x), ptr(x_out), ptr(attn_norms), ptr(ffn_norms), ptr(ada_vecs),
        ptr(sqkv), ptr(so), ptr(s13), ptr(s2), ptr(cos_p), ptr(sin_p),
        ptr(k_cache), ptr(v_cache), ptr(wqkv), ptr(wo), ptr(w13), ptr(w2),
        ptr(final_norm), ptr(lm_codes), ptr(lm_scale),
        ptr(k_new), ptr(v_new), ptr(logits),
        ptr(xq_buf), ptr(sx_buf), ptr(qkv_buf), ptr(attn_buf), ptr(up_buf),
        B, D, L, S, n_heads, n_kv, head_dim, F, V, offset,
        -1 if window is None else int(window), eps, head_dim ** -0.5,
        stream)
    check(code, "decode_stack_step")
    decode_stack_step.launches += 1
    out = (x_out, k_new, v_new)
    return out if logits is None else (*out, logits)


decode_stack_step.launches = 0
