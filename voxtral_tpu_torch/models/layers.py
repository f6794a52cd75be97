"""Shared model layers (port of ``voxtral_tpu/models/layers.py``).

Plain functions on tensors, with the JAX package's layouts and rounding
points so the two can be held against each other:

* parameters are nested dicts; per-layer stacks carry a leading layer
  axis (:func:`layer_params` slices one layer);
* dense linear weights are [in, out] (bf16 or f32), ``{"nt": w}``
  leaves dense [out, in] (the layout K1 streams in mode (g), shared with
  its fused stacks; see ``ops.decode_step.fuse_decode_weights_bf16``);
  w8 leaves ``{"w8": {codes, scale}}`` are [out, in] and go through the
  W8A8 GEMM (see :func:`voxtral_tpu_torch.ops.w8.w8_matmul`), q4 leaves
  ``{"q4": ...}`` through the q4 dispatch
  (:func:`voxtral_tpu_torch.ops.q4.q4_matmul`); ``mm`` (a
  :class:`Matmuls`) picks the kernels or their plain versions;
* matmuls accumulate in f32 and round back to the input dtype; norms,
  RoPE, softmax and GELU compute in f32;
* RoPE rotates interleaved pairs (θ = 1e6); attention masks are banded
  (``k <= q`` and ``q - k <= window``);
* the encoder and prefill attention are plain torch ops (scores and
  softmax in f32), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from voxtral_tpu_torch.ops.q4 import Q4MatmulFn, q4_matmul
from voxtral_tpu_torch.ops.q4_kernel import q4_matmul_plain
from voxtral_tpu_torch.ops.w8 import W8MatmulFn, w8_matmul
from voxtral_tpu_torch.ops.w8_kernel import w8_matmul_plain

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Matmuls:
    """The kernels a model's quantized linears run: the W8A8 GEMM (K2)
    and the packed-q4 matmul (K3).  ``None`` fields (and ``mm=None``
    everywhere) mean the kernel wrappers; :data:`PLAIN` runs the same
    model through their plain versions."""

    w8: Optional[W8MatmulFn] = None
    q4: Optional[Q4MatmulFn] = None


PLAIN = Matmuls(w8=w8_matmul_plain, q4=q4_matmul_plain)


def layer_params(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (leading layer axis)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def n_stacked(tree) -> int:
    """Length of the leading layer axis of a stacked parameter tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


# ---------------------------------------------------------------------------
# Basic ops
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           mm: Optional[Matmuls] = None) -> torch.Tensor:
    """y = x @ w (+ b), accumulated in f32, returned in x's dtype.

    ``w`` is a dense [in, out] tensor, ``{"nt": w}`` (dense [out, in],
    contracted as ``x @ w.mT`` without a transposed copy), a w8 dict
    (see ops/w8.py) or a q4 dict (see ops/q4.py).
    """
    if isinstance(w, dict):
        mm = mm or Matmuls()
        if "w8" in w:
            y = w8_matmul(x, w["w8"], mm=mm.w8)
        elif "q4" in w:
            y = q4_matmul(x, w["q4"], mm=mm.q4)
        elif "nt" in w:
            return dense_matmul(x, w["nt"].mT, b)
        else:
            raise ValueError(f"unknown weight format {sorted(w)}")
    else:
        return dense_matmul(x, w, b)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) for a dense [in, out] matrix (or a transposed view),
    the products summed in f32 and rounded once to x's dtype, as JAX's
    ``dot(..., preferred_element_type=f32)`` and ``astype``.

    bf16 x and bf16 w without a bias: one bf16 GEMM (cuBLAS sums in f32:
    :func:`~voxtral_tpu_torch.device.disable_tf32` turns its
    reduced-precision bf16 sums off) whose output rounds once to bf16,
    with no f32 copy of the weight.  Otherwise (f32 models, a bias to add
    before the rounding, mixed dtypes) the operands go to f32.
    """
    if b is None and x.dtype == w.dtype == torch.bfloat16:
        return torch.matmul(x, w)
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x * w / sqrt(mean(x^2) + eps), computed in f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in f32."""
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def swiglu(x: torch.Tensor, p: Params, mm=None) -> torch.Tensor:
    """w2(silu(w1 x) * w3 x); optional biases under keys w{1,2,3}_b."""
    gate = linear(x, p["w1"], p.get("w1_b"), mm)
    up = linear(x, p["w3"], p.get("w3_b"), mm)
    h = F.silu(gate.float()).to(x.dtype) * up
    return linear(h, p["w2"], p.get("w2_b"), mm)


def ada_modulate(x: torch.Tensor, t_embed: torch.Tensor, p: Params,
                 mm=None) -> torch.Tensor:
    """ADA t-conditioning: x * (1 + w2(gelu(w0(t_embed)))) in x's dtype."""
    scale = linear(t_embed, p["w0"], mm=mm)
    scale = gelu(scale).to(x.dtype)
    scale = linear(scale, p["w2"], mm=mm)
    return x * (scale.to(x.dtype) + torch.ones((), dtype=x.dtype,
                                               device=x.device))


# ---------------------------------------------------------------------------
# RoPE (interleaved pairs, θ = 1e6)
# ---------------------------------------------------------------------------


def rope_tables(head_dim: int, max_seq: int, theta: float = 1_000_000.0,
                device=None):
    """cos/sin tables [max_seq, head_dim // 2] in f32."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=device) * 2.0
        / head_dim))
    pos = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE; x [B, S, H, D], positions [S] (every row)
    or [B, S] (per row)."""
    b, s, h, d = x.shape
    c, si = cos[positions], sin[positions]
    if positions.dim() == 1:
        c, si = c[None], si[None]
    c, si = c[:, :, None, :], si[:, :, None, :]
    xf = x.float().reshape(b, s, h, d // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    out = torch.stack([xr * c - xi * si, xr * si + xi * c], dim=-1)
    return out.reshape(b, s, h, d).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (MHA / GQA) with banded masks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    sliding_window: Optional[int]
    causal: bool = True

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.5


def _band_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: Optional[int], causal: bool) -> torch.Tensor:
    """Additive f32 bias [Sq, Sk] ([B, Sq, Sk] for per-row positions
    [B, Sq] / [B, Sk]): 0 where allowed, -inf elsewhere; allowed =
    (k <= q) & (q - k <= window)."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    allowed = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        allowed &= diff >= 0
    if window is not None:
        allowed &= diff <= window
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(allowed, zero, float("-inf"))


def _sdpa(q, k, v, spec: AttentionSpec, q_pos, k_pos,
          k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped scaled-dot-product attention, scores and softmax in f32.

    q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's dtype.
    ``k_valid`` [Sk] masks cache slots not written yet.  ``q_pos`` /
    ``k_pos`` / ``k_valid`` may carry a leading batch axis: each row
    then has its own positions and its own mask.
    """
    b, sq, hq, d = q.shape
    groups = hq // spec.n_kv_heads
    qg = q.reshape(b, sq, spec.n_kv_heads, groups, d)
    scores = torch.einsum("bsigd,btid->bigst", qg.float(), k.float())
    scores = scores * spec.scale
    bias = _band_mask_bias(q_pos, k_pos, spec.sliding_window, spec.causal)
    if k_valid is not None:
        bias = torch.where(k_valid[..., None, :], bias, float("-inf"))
    if bias.dim() == 3:  # per row: against [B, Hkv, G, Sq, Sk]
        bias = bias[:, None, None]
    probs = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bigst,btid->bsigd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype).reshape(b, sq, hq, d)


def attention(x, p: Params, spec: AttentionSpec, cos, sin, positions,
              mm=None) -> torch.Tensor:
    """Full-sequence attention (no cache); x [B, S, d_model]."""
    b, s, _ = x.shape
    heads = (b, s, spec.n_heads, spec.head_dim)
    kv_heads = (b, s, spec.n_kv_heads, spec.head_dim)
    q = linear(x, p["wq"], p.get("wq_b"), mm).reshape(heads)
    k = linear(x, p["wk"], p.get("wk_b"), mm).reshape(kv_heads)
    v = linear(x, p["wv"], p.get("wv_b"), mm).reshape(kv_heads)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    out = _sdpa(q, k, v, spec, positions, positions)
    out = out.reshape(b, s, spec.n_heads * spec.head_dim)
    return linear(out, p["wo"], p.get("wo_b"), mm)


# ---------------------------------------------------------------------------
# KV cache (fixed shape, written in place)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Preallocated KV cache for a stack of layers.

    k, v: [L, B, max_seq, n_kv_heads, head_dim]; ``length`` = number of
    valid positions.  Unlike the JAX original the arrays are updated in
    place.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, n_layers: int, batch: int, max_seq: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (n_layers, batch, max_seq, n_kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def cache_update_layer(k_cache, v_cache, k_new, v_new, offset: int):
    """Write k_new/v_new ([B, S, Hkv, D]) at position ``offset`` of one
    layer's cache ([B, max_seq, Hkv, D]) in place; returns (k, v)."""
    s = k_new.shape[1]
    k_cache[:, offset:offset + s] = k_new.to(k_cache.dtype)
    v_cache[:, offset:offset + s] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def ring_slot(offset, head: int, size: int):
    """Physical slot of absolute position ``offset`` (an int or an int
    tensor) in a head+ring cache: slots [0, head) hold positions
    [0, head) for good; slots [head, head + size) hold position
    p >= head at head + (p - head) % size."""
    if isinstance(offset, torch.Tensor):
        return torch.where(offset < head, offset,
                           head + torch.remainder(offset - head, size))
    return offset if offset < head else head + (offset - head) % size


def ring_k_positions(head: int, size: int, written, device=None,
                     slots: Optional[int] = None):
    """(absolute position, validity) per slot of a head+ring cache after
    ``written`` positions were appended, each [slots] (default head +
    size).

    Ring slot r was last written by the largest p = head + r + size * c
    below ``written``; unwritten slots get a meaningless position and
    valid = False, as do slots past head + size of a longer cache.
    ``written`` an int, or an int tensor that broadcasts against the slot
    axis (per-stream offsets [Bc, 1] give [Bc, slots]).
    """
    if isinstance(written, torch.Tensor):
        written, device = written.long(), written.device
    j = torch.arange(head + size if slots is None else slots, device=device)
    in_head = j < head
    r = j - head
    wr = written - head
    cycles = torch.div(wr - 1 - r, size, rounding_mode="floor")
    p = torch.where(in_head, j, head + r + size * cycles)
    valid = torch.where(in_head, j < written, (r < size) & (r < wr))
    return p, valid


def attention_with_cache(x, p: Params, spec: AttentionSpec, cos, sin,
                         k_cache, v_cache, offset, mm=None,
                         pos_base: int = 0,
                         ring: Optional[tuple[int, int]] = None):
    """Append this block's K/V to the cache at ``offset``, attend over
    everything written so far.

    x [B, S, d_model]; k_cache/v_cache [B, max_seq, Hkv, D]; ``offset``
    = positions appended so far.  ``pos_base``: absolute position of
    slot 0 (RoPE and the band mask see absolute positions).  ``ring``:
    ``(head, size)`` makes the cache a head+ring buffer of head + size
    slots (positions < head permanent, later ones wrap modulo size);
    a write must fit one region, as the callers align it, and
    ``pos_base`` stays 0.  ``offset`` an int tensor [B] (the pooled
    step): each row appends at its own offset, with its own RoPE
    positions, band mask and (ring) write slots, in one batched pass
    (JAX vmaps the batch-1 function over the slots).
    """
    b, s, _ = x.shape
    dev = x.device
    rows = isinstance(offset, torch.Tensor)
    if rows:
        offset = offset.long()[:, None]  # [B, 1] against the S axis
    positions = pos_base + offset + torch.arange(s, device=dev)
    q = linear(x, p["wq"], p.get("wq_b"), mm).reshape(
        b, s, spec.n_heads, spec.head_dim)
    k = linear(x, p["wk"], p.get("wk_b"), mm).reshape(
        b, s, spec.n_kv_heads, spec.head_dim)
    v = linear(x, p["wv"], p.get("wv_b"), mm).reshape(
        b, s, spec.n_kv_heads, spec.head_dim)
    if rows:
        # A row past its table's end (a parked stream) reads the last
        # entry, as a JAX gather clamps; its output is discarded.
        at = positions.clamp(max=cos.shape[0] - 1)
        q, k = apply_rope(q, cos, sin, at), apply_rope(k, cos, sin, at)
        first = offset if ring is None else ring_slot(offset, *ring)
        write = first + torch.arange(s, device=dev)  # [B, S] slots
        batch = torch.arange(b, device=dev)[:, None]
        k_cache[batch, write] = k.to(k_cache.dtype)
        v_cache[batch, write] = v.to(v_cache.dtype)
        if ring is None:
            slots = torch.arange(k_cache.shape[1], device=dev)
            k_pos, k_valid = pos_base + slots, slots < offset + s
        else:
            k_pos, k_valid = ring_k_positions(*ring, offset + s)
        out = _sdpa(q, k_cache, v_cache, spec, positions, k_pos, k_valid)
        out = out.reshape(b, s, spec.n_heads * spec.head_dim)
        return linear(out, p["wo"], p.get("wo_b"), mm), k_cache, v_cache
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if ring is None:
        k_cache, v_cache = cache_update_layer(k_cache, v_cache, k, v, offset)
        slots = torch.arange(k_cache.shape[1], device=dev)
        k_pos, k_valid = pos_base + slots, slots < offset + s
    else:
        head, size = ring
        k_cache, v_cache = cache_update_layer(
            k_cache, v_cache, k, v, ring_slot(offset, head, size))
        k_pos, k_valid = ring_k_positions(head, size, offset + s, dev)
    out = _sdpa(q, k_cache, v_cache, spec, positions, k_pos, k_valid)
    out = out.reshape(b, s, spec.n_heads * spec.head_dim)
    return linear(out, p["wo"], p.get("wo_b"), mm), k_cache, v_cache


# ---------------------------------------------------------------------------
# Conv downsampler (2x Conv1d k=3 s=2 p=1 + GELU)
# ---------------------------------------------------------------------------


def conv_downsample(x: torch.Tensor, p: Params) -> torch.Tensor:
    """[B, n_mels, T] -> [B, out_channels, T/4], convolutions in f32.

    Weights conv{1,2} [out_ch, in_ch, k], biases conv{1,2}_b [out_ch].
    """

    def conv1d(h, w, b):
        y = F.conv1d(h.float(), w.float(), stride=2, padding=1)
        return y + b.float()[None, :, None]

    y = F.gelu(conv1d(x, p["conv1"], p["conv1_b"]), approximate="none")
    y = conv1d(y.to(x.dtype), p["conv2"], p["conv2_b"])
    return F.gelu(y, approximate="none").to(x.dtype)


# ---------------------------------------------------------------------------
# Transformer blocks
# ---------------------------------------------------------------------------


def encoder_block(x, p: Params, spec: AttentionSpec, cos, sin, positions,
                  eps: float, mm=None) -> torch.Tensor:
    """Pre-LN encoder layer: x + Attn(RMS(x)); x + SwiGLU(RMS(x))."""
    h = rms_norm(x, p["attention_norm"], eps)
    x = x + attention(h, p["attention"], spec, cos, sin, positions, mm)
    h = rms_norm(x, p["ffn_norm"], eps)
    return x + swiglu(h, p["ffn"], mm)


def decoder_block_with_cache(x, t_embed, p: Params, spec: AttentionSpec, cos,
                             sin, k_cache, v_cache, offset: int, eps: float,
                             mm=None, pos_base: int = 0,
                             ring: Optional[tuple[int, int]] = None):
    """Decoder layer with KV cache; ADA modulation after ffn_norm.
    ``pos_base`` / ``ring`` as in :func:`attention_with_cache`."""
    h = rms_norm(x, p["attention_norm"], eps)
    attn_out, k_cache, v_cache = attention_with_cache(
        h, p["attention"], spec, cos, sin, k_cache, v_cache, offset, mm,
        pos_base, ring)
    x = x + attn_out
    h = rms_norm(x, p["ffn_norm"], eps)
    h = ada_modulate(h, t_embed, p["ada"], mm)
    x = x + swiglu(h, p["ffn"], mm)
    return x, k_cache, v_cache
