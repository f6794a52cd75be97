"""K4, K5, K6: the tensor-parallel halves of a decode step, hand-written
CUDA for Hopper, and the mesh-level step built on them.

Port of ``voxtral_tpu/ops/decode_tp_pallas.py``.  A decoder layer has
two reduction points, after WO and after W2, where tensor-parallel
shards must add up their partial sums; a collective cannot run inside a
kernel, so the layer splits there into two halves per shard:

* K4 :func:`attn_half_step` (``attn_half_step``, ``:603``): rms_norm,
  W8A8 QKV of the shard's heads, RoPE, GQA attention over the shard's
  KV heads (offsets, window and ``spec`` rows as K1; the head+ring
  cache, the int8 cache and the chunked walk, K1's modes (d), (e) and
  (f) over the local heads), the WO partial;
* K5 :func:`ffn_half_step` (``ffn_half_step``, ``:763``): ffn_norm x
  ADA, W1 / W3 of the shard's F rows, SwiGLU, the W2 partial;
* K6 :func:`lm_half_argmax` (``lm_half_argmax``, ``:1285``): the final
  norm, the activation quant and the shard's vocab rows of the tied
  lm_head with the (max, first index) fold, so no logits are written.

:func:`tp_decode_step` runs all layers over the mesh: per layer and data
group, K4 on every model shard, ``collectives.psum``, the residual add,
K5, ``psum``, the add (JAX: ``xc + psum(y)``, ``:1071-1075``: the sum
first, then the add).  :func:`tp_lm_head_token` runs K6 per shard and
resolves the token (``collectives.argmax_resolve``).  The weights come
from :func:`tp_shard_fused_weights` / :func:`tp_shard_lm_head`, pure
re-slicings of K1's stacks equal to JAX's arrays (leading shard axis),
placed on the shards' devices by :func:`place_shards`.

Two weight formats, picked by the scales' rank as K1 picks mode (h):
w8 (int8 codes, f32 row scales) and g32, the exact Q4_0 weights of a
q4g model (int8 codes = nibble - 8 with f16 group scales [N, K/32], the
g32 halves of ``_half_plan`` / ``_stream_factory`` with ``wg``,
``:72-142``, and ``_make_lm_half``'s, ``:1228-1279``), from
:func:`tp_shard_fused_weights_q4g` / :func:`tp_shard_lm_head_q4g`: the
port's own layout (K1 mode (h)'s [L, N, K] codes), so the values equal
JAX's shards and the arrays do not.  A row-parallel g32 shard (wo, w2)
holds its K columns and their K/32 scale columns.

Numerics, as JAX's: each shard quantizes its attention output and its
SwiGLU rows with its LOCAL row absmax (``:43-47``), so a tp run is not
bit-equal to the single-device step; the plain versions here quantize
the same way.  Every float reduction sums in f64 and rounds once, in
kernel and plain version alike (K1's rule), so the two agree bit for
bit.

``tp_vmem_need`` / ``TP_VMEM_CAP`` are TPU-only; :func:`check_tp_geometry`
checks what the card refuses (the attention block's shared memory, the
chunk, the ring, the shard divisibility) and, for q4g, JAX's g32 gate
(:func:`check_tp_q4g`).

K4 and K5 each go out as one chain of programmatic dependent launches
(:data:`TP_PDL`); where each linear quantizes its input rows (in its
GEMV's prologue, or a row kernel before it), whether K5's w13 puts the
SwiGLU in its epilogue and which GEMV each runs is
:func:`tp_gemv_plan`'s, per weight format, row count and linear
(``csrc/tp_gemv.cu``).  The scratch of a call is kept per device,
stream and shape (:func:`_scratch`).

What bounds the kernels on the H100 at tp = 2, full width, one row:
K4 the layer's 15.73 MB of local weights (16.71 MB of g32 codes and
scales) and the visible slots of the local cache (bf16, or int8 codes
and scales), K5 42.47 MB (45.12 MB in g32), K6 the 201.6 MB vocab shard
(213.9 MB in g32) (``csrc/decode_tp.cu``).  A position
is 26 x (K4 + K5) wrapper calls per shard and two sums per layer from
the host, the per-layer route's host cost: on one card a tp run shows
correctness, not tensor parallelism's speed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from voxtral_tpu_torch.ops._build import check, kernel_fn
from voxtral_tpu_torch.ops.decode_step import (
    _attention_plain,
    _card_index,
    _check_cache_mode,
    _linear_plain,
    _plan_array,
    _rms,
    _rope_swap,
    _sm_count,
    _spec_streams,
    check_geometry,
    g32_matmul_plain,
    stream_plan,
)
from voxtral_tpu_torch.ops.w8 import quantize_activations as _quant
from voxtral_tpu_torch.ops.w8_kernel import w8_matmul_plain
from voxtral_tpu_torch.parallel.collectives import argmax_resolve, psum
from voxtral_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    row_groups,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

Params = dict


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def tp_shard_fused_weights(fused: Params, n_heads: int, n_kv: int,
                           head_dim: int, hidden: int, tp: int) -> Params:
    """K1's w8 stacks (``ops.decode_step.fuse_decode_weights``) resliced
    for ``tp`` shards, with a LEADING shard axis, as JAX's
    ``tp_shard_fused_weights`` (``decode_tp_pallas.py:837-887``):
    wqkv [tp, L, nqkv_l, D] (each shard's q, k and v rows re-concatenated)
    and sqkv [tp, L, nqkv_l]; wo [tp, L, D, nq_l] (row-parallel: the
    shard's input columns) with ``so`` replicated [tp, L, D]; w13
    [tp, L, 2 F_l, D] (its w1 rows, then its w3 rows) and s13; w2
    [tp, L, D, F_l] with ``s2`` replicated."""
    if n_kv % tp or hidden % tp:
        raise ValueError(f"tp={tp} must divide n_kv={n_kv} and "
                         f"hidden={hidden}")
    nq, nkv = n_heads * head_dim, n_kv * head_dim
    nq_l, nkv_l, fl = nq // tp, nkv // tp, hidden // tp

    def seg(a, i, parts):
        return torch.cat([a[:, s + i * n:s + (i + 1) * n] for s, n in parts],
                         dim=1)

    qkv = [(0, nq_l), (nq, nkv_l), (nq + nkv, nkv_l)]
    f13 = [(0, fl), (hidden, fl)]
    return {
        "wqkv": torch.stack([seg(fused["wqkv"], i, qkv) for i in range(tp)]),
        "sqkv": torch.stack([seg(fused["sqkv"], i, qkv) for i in range(tp)]),
        "wo": torch.stack([fused["wo"][:, :, i * nq_l:(i + 1) * nq_l]
                           for i in range(tp)]),
        "so": torch.stack([fused["so"]] * tp),
        "w13": torch.stack([seg(fused["w13"], i, f13) for i in range(tp)]),
        "s13": torch.stack([seg(fused["s13"], i, f13) for i in range(tp)]),
        "w2": torch.stack([fused["w2"][:, :, i * fl:(i + 1) * fl]
                           for i in range(tp)]),
        "s2": torch.stack([fused["s2"]] * tp),
    }


def tp_shard_lm_head(w8: Params, tp: int) -> Params:
    """A rowwise-w8 tied table {"codes": [V, D], "scale": [V]} split on
    the vocab axis into contiguous ascending shards: codes [tp, V/tp, D],
    scale [tp, V/tp] (views; JAX ``tp_shard_lm_head``, ``:1186-1202``)."""
    codes, scale = w8["codes"], w8["scale"]
    V, D = codes.shape
    if V % tp:
        raise ValueError(f"tp={tp} must divide vocab={V}")
    return {"codes": codes.reshape(tp, V // tp, D),
            "scale": scale.reshape(tp, V // tp)}


def check_tp_q4g(n_heads: int, n_kv: int, head_dim: int, hidden: int,
                 tp: int) -> None:
    """ValueError naming JAX's gate for the g32 halves
    (``decode_tp_pallas.py:910-915``, ``models/voxtral.py:880-890``):
    ``tp`` divides n_kv and hidden, and the LOCAL contraction widths
    nq / tp and hidden / tp are multiples of 128.  The port's layout
    would take any multiple of 32; the gate is JAX's, so both packages
    route the same configurations to the g32 halves (ROADMAP §3)."""
    nq = n_heads * head_dim
    if n_kv % tp or hidden % tp or (nq // tp) % 128 or (hidden // tp) % 128:
        raise ValueError(
            f"q4g TP needs tp={tp} to divide n_kv={n_kv} and hidden="
            f"{hidden}, and local contraction dims % 128 (nq/tp={nq // tp}, "
            f"hidden/tp={hidden // tp})")


def tp_shard_fused_weights_q4g(fused: Params, n_heads: int, n_kv: int,
                               head_dim: int, hidden: int,
                               tp: int) -> Params:
    """K1's g32 stacks (``ops.decode_step.fuse_decode_weights_q4g``: codes
    [L, N, K] int8, f16 group scales [L, N, K/32]) resliced for ``tp``
    shards with a LEADING shard axis, the values of JAX's
    ``tp_shard_fused_weights_q4g`` (``decode_tp_pallas.py:890-955``) in
    the port's layout: wqkv / sqkv and w13 / s13 column-parallel, rows
    in the segments of :func:`tp_shard_fused_weights`; wo / so and w2 /
    s2 row-parallel, each shard its K columns and its K/32 scale columns
    (not replicated, unlike w8's ``so`` / ``s2``).  ValueError outside
    :func:`check_tp_q4g`'s gate."""
    check_tp_q4g(n_heads, n_kv, head_dim, hidden, tp)
    nq, nkv = n_heads * head_dim, n_kv * head_dim
    nq_l, nkv_l, fl = nq // tp, nkv // tp, hidden // tp

    def seg(a, i, parts):
        return torch.cat([a[:, s + i * n:s + (i + 1) * n] for s, n in parts],
                         dim=1)

    def cols(a, i, k_l):  # shard i's K columns (codes) or groups (scales)
        return a[:, :, i * k_l:(i + 1) * k_l]

    qkv = [(0, nq_l), (nq, nkv_l), (nq + nkv, nkv_l)]
    f13 = [(0, fl), (hidden, fl)]
    out = {}
    for name, parts in (("wqkv", qkv), ("sqkv", qkv), ("w13", f13),
                        ("s13", f13)):
        out[name] = torch.stack([seg(fused[name], i, parts)
                                 for i in range(tp)])
    for codes, scales, k_l in (("wo", "so", nq_l), ("w2", "s2", fl)):
        out[codes] = torch.stack([cols(fused[codes], i, k_l)
                                  for i in range(tp)])
        out[scales] = torch.stack([cols(fused[scales], i, k_l // 32)
                                   for i in range(tp)])
    return out


def tp_shard_lm_head_q4g(lm_codes: torch.Tensor, lm_scale: torch.Tensor,
                         tp: int) -> Params:
    """A g32 tied table (codes [V, D] int8, f16 group scales [V, D/32],
    ``fuse_decode_weights_q4g``'s ``lm_codes`` / ``lm_scale``) split on
    the vocab axis into contiguous ascending shards: codes
    [tp, V/tp, D], scale [tp, V/tp, D/32] (views; JAX
    ``tp_shard_lm_head_q4g``, ``:1205-1226``)."""
    V, D = lm_codes.shape
    if V % tp:
        raise ValueError(f"tp={tp} must divide vocab={V}")
    return {"codes": lm_codes.reshape(tp, V // tp, D),
            "scale": lm_scale.reshape(tp, V // tp, D // 32)}


def place_shards(mesh: Mesh, stacked: Params) -> Params:
    """Each leaf [tp, ...] of ``stacked`` as a grid ``[d][i]`` of shard
    ``i`` on ``mesh.devices[d][i]`` (shard i of every data group).  Where
    every device of the mesh is the leaf's own (shards sharing one card),
    a shard is a view of the leaf; otherwise each is a tensor of its own,
    so the stacked leaf can be freed."""
    tp = mesh.shape[MODEL_AXIS]
    devices = {dev for row in mesh.devices for dev in row}
    out = {}
    for name, leaf in stacked.items():
        if leaf.shape[0] != tp:
            raise ValueError(f"{name}: {leaf.shape[0]} shards for a mesh of "
                             f"{tp} model shards")
        copy = devices != {leaf.device}
        out[name] = [[leaf[i].to(dev, copy=copy) for i, dev in enumerate(row)]
                     for row in mesh.devices]
    return out


def gather_kv(parts: list) -> torch.Tensor:
    """The grid ``[d][i]`` of per-shard k_new / v_new [L, B_d, Hkv_l, hd]
    as one [L, B, Hkv, hd] on the first shard's device."""
    dev = parts[0][0].device
    return torch.cat([torch.cat([p.to(dev) for p in row], dim=2)
                      for row in parts], dim=1)


def check_tp_geometry(S: int, head_dim: int, window: Optional[int],
                      spec: int, n_kv: int, hidden: int, tp: int,
                      ring: Optional[tuple[int, int]] = None,
                      cache_chunk: Optional[int] = None,
                      kv_int8: bool = False) -> None:
    """ValueError naming the cause when the TP halves cannot take this
    geometry: ``tp`` must divide the KV heads and the FFN rows (JAX's
    shard rules; a vocabulary tp does not divide keeps the whole lm_head
    on the mesh's first device, as JAX's, ``models/voxtral.py:934-946``),
    and K4's attention blocks are K1's
    (``ops.decode_step.check_geometry``: the score buffer in shared
    memory, S or the window's floats resident, the chunk's chunked; the
    ring within S; no spec rows on a chunked walk), whatever the shard's
    head count.  Replaces JAX's ``tp_vmem_need`` / ``TP_VMEM_CAP``, which
    budget TPU VMEM.  (A meshed q4g model passed :func:`check_tp_q4g`
    when it was built.)"""
    if n_kv % tp or hidden % tp:
        raise ValueError(f"tp={tp} must divide n_kv={n_kv} and "
                         f"hidden={hidden}")
    check_geometry(S, head_dim, window, spec, ring, cache_chunk, kv_int8)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _fmt(scales: torch.Tensor) -> str:
    """A half's weight format from one layer's scales: "g32" for group
    scales [N, K/32], "w8" for row scales [N] (K1's rule, by rank)."""
    return "g32" if scales.dim() == 2 else "w8"


def _rope_rows(cos_b, sin_b):
    """cos / sin [hd] (every row) or [B, hd] as [..., 1, hd] against the
    heads."""
    c, s = cos_b.float(), sin_b.float()
    return (c[:, None], s[:, None]) if c.dim() == 2 else (c, s)


def attn_half_step_plain(x, layer: int, offsets, attn_norm, sqkv, so, cos_b,
                         sin_b, k_cache_l, v_cache_l, wqkv, wo,
                         k_scales=None, v_scales=None, *,
                         n_heads_l: int, n_kv_l: int, head_dim: int,
                         eps: float, window: Optional[int] = None,
                         spec: int = 1,
                         ring: Optional[tuple[int, int]] = None,
                         cache_chunk: Optional[int] = None):
    """Plain PyTorch version of K4, as the JAX kernel computes it: K1's
    layer on the shard's heads (K1's attention walk: the ring map of
    ``models.layers.ring_k_positions``, the int8 scores and requant
    groups, the chunks in slot order), the WO input quantized with its
    local absmax, no residual; W8A8 or, with group scales, g32
    (``_linear_plain``, K1 mode (h)'s).  JAX's guards: an int8 cache
    needs its scales, spec rows refuse a chunked walk, the chunk divides
    S.
    -> (partial [B, D] f32, k_new, v_new [B, Hkv_l, hd]: bf16 over an
    int8 cache, else the cache dtype)."""
    B = x.shape[0]
    Bc = _spec_streams(B, k_cache_l.shape[0], spec)
    _check_cache_mode(k_cache_l, v_cache_l, k_scales, v_scales, cache_chunk,
                      spec, k_cache_l.shape[2])
    nq, nkv = n_heads_l * head_dim, n_kv_l * head_dim
    c, s = _rope_rows(cos_b, sin_b)
    offs = torch.as_tensor(offsets, device=x.device).reshape(-1).expand(Bc)
    h = _rms(x.float(), attn_norm.float(), eps)
    fmt = _fmt(sqkv)
    qkv = _linear_plain(h, wqkv[layer], sqkv, fmt)
    q = qkv[:, :nq].reshape(B, n_heads_l, head_dim)
    k = qkv[:, nq:nq + nkv].reshape(B, n_kv_l, head_dim)
    v = qkv[:, nq + nkv:].reshape(B, n_kv_l, head_dim)
    q = q * c + _rope_swap(q) * s
    k = k * c + _rope_swap(k) * s
    attn = _attention_plain(q, k, v, k_cache_l, v_cache_l, offs, window,
                            spec, n_kv_l, head_dim ** -0.5, ring, k_scales,
                            v_scales, cache_chunk)
    new = torch.bfloat16 if k_scales is not None else k_cache_l.dtype
    return _linear_plain(attn, wo[layer], so, fmt), k.to(new), v.to(new)


def ffn_half_step_plain(x, layer: int, ffn_norm, ada_vec, s13, s2, w13, w2,
                        *, eps: float):
    """Plain PyTorch version of K5: ffn_norm x ADA, the shard's W1 / W3,
    SwiGLU quantized with its local absmax, the W2 partial [B, D] f32
    (W8A8, or g32 with group scales)."""
    hidden = w2.shape[2]
    fmt = _fmt(s13)
    h = _rms(x.float(), ffn_norm.float(), eps) * ada_vec.float()
    up = _linear_plain(h, w13[layer], s13, fmt)
    gate, upv = up[:, :hidden], up[:, hidden:]
    hmid = gate * (1.0 / (1.0 + torch.exp(-gate))) * upv
    return _linear_plain(hmid, w2[layer], s2, fmt)


def lm_half_argmax_plain(x, final_norm, lm_scale_l, lm_codes_l, *,
                         eps: float):
    """Plain PyTorch version of K6: the shard's logits (final norm, per-row
    int8 quant, ``(float(z) * sx) * scale``, or over a g32 shard
    ``float(sum_g z_g * s_g) * sx``, K1 mode (h)'s lm_head) and their
    largest value and first local index -> (max [B, 1] f32, index [B, 1]
    int32)."""
    xq, sx = _quant(_rms(x.float(), final_norm.float(), eps))
    matmul = (g32_matmul_plain if _fmt(lm_scale_l) == "g32"
              else w8_matmul_plain)
    logits = matmul(xq, sx, lm_codes_l, lm_scale_l)
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    return logits.gather(1, idx), idx.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Whether K4 and K5 launch their kernels as programmatic dependent
# launches (True), or in plain stream order (False: the same kernels, for
# a breakdown by launch class, benches/torch_tp_times.py --breakdown).
TP_PDL = True

# Plan bits of one linear of K4 / K5 (csrc/tp_gemv.cu::tp_linear).
PLAN_FUSED = 1       # the GEMV quantizes its input rows itself
PLAN_PAIR = 2        # two weight rows a warp (w8, up to 2 rows)
PLAN_MMA = 4         # the split-K int8 tensor-core GEMV (w8, up to 16 rows)
PLAN_AHEAD = 8       # the linear's first launch goes ahead of its predecessor
PLAN_GEMV_AHEAD = 16  # the GEMV after a row kernel goes ahead of it
PLAN_SWIGLU = 32     # w13 puts the SwiGLU in its epilogue (w8 up to 8
                     # rows, g32 up to 4)
# The linears of the halves, in launch order: K4's, then K5's.
TP_LINEARS = ("qkv", "wo", "w13", "w2")


def tp_gemv_plan(fmt: str, rows: int, linear: str) -> int:
    """The plan bits of one linear of K4 / K5 (csrc/tp_gemv.cu): weight
    format ``fmt`` ("w8" / "g32"), ``rows`` activation rows, ``linear``
    one of TP_LINEARS (its shard's shape: wqkv_l 3072 x 3072, wo_l 3072 x
    2048, w13_l 9216 x 3072, w2_l 3072 x 4608 at tp = 2).  From the sweep of
    benches/torch_tp_times.py --plans on the H100 (PERF.md):

    * qkv and w13 follow a PyTorch kernel (the residual add): the row
      kernel and the GEMV both go ahead; w13 in w8 up to 8 rows and in
      g32 at 2-4 rows puts the SwiGLU in its epilogue (a warp on a gate
      row and its up row), so w2's row needs no gate (g32 at 1 and 8
      rows measured slower so);
    * at one w8 row wo and w2 quantize their input row themselves, their
      weights streaming under the attention or w13; wo takes two weight
      rows a warp there and at 2 rows, the split-K tensor-core GEMV at 8;
      w2 after a gated w13 launches its row kernel ahead;
    * otherwise wo and w2 start their row kernel after the predecessor
      ends and launch the GEMV ahead of it.

    K4's attention stays in stream order after the qkv GEMV (launched
    ahead, as K1 launches it, it measured slower).  The kernel library
    keeps only the routes this rule returns; the sweep lives in the
    bench.
    """
    if fmt not in ("w8", "g32") or linear not in TP_LINEARS or rows < 1:
        raise ValueError(f"tp_gemv_plan: no plan for {fmt} {linear} at "
                         f"{rows} rows")
    ahead = PLAN_AHEAD | PLAN_GEMV_AHEAD
    w8 = fmt == "w8"
    if linear == "qkv":
        return ahead
    gated = rows <= 8 if w8 else 2 <= rows <= 4
    if linear == "w13":
        return ahead | (PLAN_SWIGLU if gated else 0)
    if w8 and rows == 1:
        return PLAN_FUSED | PLAN_AHEAD | (PLAN_PAIR if linear == "wo" else 0)
    if w8 and linear == "wo" and rows in (2, 8):
        return ahead | (PLAN_PAIR if rows == 2 else PLAN_MMA)
    if linear == "w2" and gated:
        return ahead
    return PLAN_GEMV_AHEAD


# Scratch buffers of the halves, one set per (device, stream, shape):
# the kernels of one stream run in order, so a call may reuse the
# previous call's scratch.  A CUDA graph captured on a stream keeps that
# stream's set, so the graphs captured on one stream share it: replay
# one of them at a time.
_SCRATCH: dict = {}


def _scratch(dev, stream: int, key: tuple, specs: tuple) -> tuple:
    """The tensors of ``specs`` ((shape, dtype), ...) for ``key`` on
    ``dev`` / ``stream``, allocated once.  Safe in stream order only:
    two CUDA graphs captured on one stream hold the same tensors, so
    they must not replay at once."""
    got = _SCRATCH.get((dev, stream, key))
    if got is None:
        got = tuple(torch.empty(shape, dtype=dt, device=dev)
                    for shape, dt in specs)
        _SCRATCH[(dev, stream, key)] = got
    return got


@functools.cache
def _entry(name: str):
    """The C entry points of the halves, their ctypes signatures set."""
    sigs = {"vx_attn_half_step": [_P, _P, _I] + [_P] * 18 + [_I] * 14
            + [_F, _F] + [_I] * 3 + [_P],
            "vx_ffn_half_step": [_P, _P, _I] + [_P] * 9 + [_I] * 4
            + [_F] + [_I] * 3 + [_P]}
    return kernel_fn(name, sigs[name])


def _expect(fn: str, dev, specs: dict) -> None:
    """ValueError unless each tensor has its dtype and shape, lies on
    ``dev`` and is contiguous."""
    for name, (t, dtype, shape) in specs.items():
        if t is None or t.dtype != dtype or t.shape != shape:
            raise ValueError(
                f"{fn}: {name} must be {dtype} {shape}, got "
                f"{None if t is None else (t.dtype, tuple(t.shape))}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous on {dev}")


def _g32_ready(fn: str, widths: dict, codes: dict) -> None:
    """ValueError unless each contraction width is a multiple of 32 and
    each tensor of codes or group scales starts 16-byte aligned (the
    g32 GEMVs' 16-byte loads, ``csrc/w8_common.cuh``)."""
    for name, k in widths.items():
        if k % 32:
            raise ValueError(f"{fn}: g32 weights need {name} % 32 == 0, "
                             f"got {k}")
    for name, t in codes.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: g32 {name} must start 16-byte aligned")


def _device_of(fn: str, x: torch.Tensor) -> Optional[torch.device]:
    """None for a CPU tensor (the plain version runs), the CUDA device
    otherwise; RuntimeError for any other device."""
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise RuntimeError(f"{fn}: unsupported device {x.device}")
    return x.device


def attn_half_step(x, layer: int, offsets, attn_norm, sqkv, so, cos_b,
                   sin_b, k_cache_l, v_cache_l, wqkv, wo, k_scales=None,
                   v_scales=None, *, n_heads_l: int, n_kv_l: int,
                   head_dim: int, eps: float, window: Optional[int] = None,
                   spec: int = 1, ring: Optional[tuple[int, int]] = None,
                   cache_chunk: Optional[int] = None):
    """K4: one layer's attention half on this shard's heads.

    x [B, D] f32 (B = streams x ``spec`` rows, ordered (stream, draft
    slot)); ``layer`` an int; ``offsets`` the cache slots written per
    stream (absolute positions on a head+ring cache), an int or an int32
    tensor [streams] on x's device; layer ``layer``'s attn_norm [D], sqkv
    [nqkv_l] and ``so`` [D] f32; cos_b / sin_b [hd] or per row [B, hd]
    f32; this layer's LOCAL head-major caches [streams, Hkv_l, S, hd]
    bf16, or int8 codes with ``k_scales`` / ``v_scales`` [streams, Hkv_l,
    S] f32 (K1 mode (e)); the shard's stacks wqkv [L, nqkv_l, D], wo [L,
    D, nq_l] int8.  ``ring`` = (head, size): a head+ring cache (mode
    (d)); ``cache_chunk``: the chunked walk (mode (f), spec = 1).  g32
    weights (q4g, :func:`tp_shard_fused_weights_q4g`): sqkv [nqkv_l,
    D/32] and ``so`` [D, nq_l/32] f16 group scales, the shard's own.
    Returns (the WO partial [B, D] f32, k_new, v_new [B, Hkv_l, hd]
    bf16).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/decode_tp.cu``) or raise.  Each launch adds one to
    ``attn_half_step.launches``, a g32 one also to
    ``attn_half_step.g32_launches``.
    """
    args = (x, layer, offsets, attn_norm, sqkv, so, cos_b, sin_b, k_cache_l,
            v_cache_l, wqkv, wo, k_scales, v_scales)
    kw = dict(n_heads_l=n_heads_l, n_kv_l=n_kv_l, head_dim=head_dim,
              eps=eps, window=window, spec=spec, ring=ring,
              cache_chunk=cache_chunk)
    dev = _device_of("attn_half_step", x)
    if dev is None:
        return attn_half_step_plain(*args, **kw)
    B, D = x.shape
    Bc, _, S, _ = k_cache_l.shape
    Bc = _spec_streams(B, Bc, spec)
    L = wqkv.shape[0]
    nq, nkv = n_heads_l * head_dim, n_kv_l * head_dim
    int8 = k_scales is not None
    _check_cache_mode(k_cache_l, v_cache_l, k_scales, v_scales, cache_chunk,
                      spec, S)
    if not (isinstance(layer, int) and 0 <= layer < L):
        raise ValueError(f"attn_half_step: layer must be an int in "
                         f"[0, {L}), got {layer!r}")
    if not (head_dim % (4 if int8 else 2) == 0 and head_dim <= 256
            and n_heads_l % n_kv_l == 0):
        raise ValueError("attn_half_step: head_dim must be even (a multiple "
                         "of 4 on an int8 cache) and <= 256, n_kv_l must "
                         "divide n_heads_l")
    check_geometry(S, head_dim, window, spec, ring, cache_chunk, int8)
    offs = None
    if isinstance(offsets, torch.Tensor):
        _expect("attn_half_step", dev,
                {"offsets": (offsets, torch.int32, (Bc,))})
        offs, offsets = offsets, 0
    if not (isinstance(offsets, int) and 0 <= offsets
            and (ring is not None or offsets <= S)):
        raise ValueError(f"attn_half_step: offset must be an int in "
                         f"[0, {S}] (any >= 0 on a ring) or a tensor, got "
                         f"{offsets!r}")
    f32 = torch.float32
    cdt = torch.int8 if int8 else torch.bfloat16
    rope = (head_dim,) if cos_b.dim() == 1 else (B, head_dim)
    g32 = _fmt(sqkv) == "g32"
    sdt = torch.float16 if g32 else f32
    specs = {
        "x": (x, f32, (B, D)), "attn_norm": (attn_norm, f32, (D,)),
        "sqkv": (sqkv, sdt, (nq + 2 * nkv, D // 32) if g32
                 else (nq + 2 * nkv,)),
        "so": (so, sdt, (D, nq // 32) if g32 else (D,)),
        "cos_b": (cos_b, f32, rope), "sin_b": (sin_b, f32, rope),
        "k_cache_l": (k_cache_l, cdt, (Bc, n_kv_l, S, head_dim)),
        "v_cache_l": (v_cache_l, cdt, (Bc, n_kv_l, S, head_dim)),
        "wqkv": (wqkv, torch.int8, (L, nq + 2 * nkv, D)),
        "wo": (wo, torch.int8, (L, D, nq)),
    }
    if int8:
        specs.update(k_scales=(k_scales, f32, (Bc, n_kv_l, S)),
                     v_scales=(v_scales, f32, (Bc, n_kv_l, S)))
    _expect("attn_half_step", dev, specs)
    if g32:
        _g32_ready("attn_half_step", {"D": D, "nq_l": nq},
                   {"wqkv": wqkv, "wo": wo, "sqkv": sqkv, "so": so})
    fmt = "g32" if g32 else "w8"
    y = torch.empty((B, D), dtype=f32, device=dev)
    k_new, v_new = torch.empty((2, B, n_kv_l, head_dim),
                               dtype=torch.bfloat16, device=dev).unbind(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        xq, sx, qkv, att = _scratch(dev, stream, ("K4", B, D, nq, nkv), (
            ((B, max(D, nq)), torch.int8), ((B,), f32),
            ((B, nq + 2 * nkv), f32), ((B, nq), f32)))
        code = _entry("vx_attn_half_step")(
            x.data_ptr(), y.data_ptr(), layer, attn_norm.data_ptr(),
            sqkv.data_ptr(), so.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
            k_cache_l.data_ptr(), v_cache_l.data_ptr(),
            k_scales.data_ptr() if int8 else None,
            v_scales.data_ptr() if int8 else None, wqkv.data_ptr(),
            wo.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), xq.data_ptr(),
            sx.data_ptr(), qkv.data_ptr(), att.data_ptr(),
            None if offs is None else offs.data_ptr(), B, D, S, n_heads_l,
            n_kv_l, head_dim, offsets, spec,
            0 if cos_b.dim() == 1 else head_dim,
            -1 if window is None else int(window),
            0 if ring is None else ring[0], 0 if ring is None else ring[1],
            cache_chunk or 0, int(g32), eps, head_dim ** -0.5,
            tp_gemv_plan(fmt, B, "qkv"), tp_gemv_plan(fmt, B, "wo"),
            int(TP_PDL), stream)
    check(code, "attn_half_step")
    attn_half_step.launches += 1
    attn_half_step.g32_launches += int(g32)
    return y, k_new, v_new


attn_half_step.launches = 0
attn_half_step.g32_launches = 0


def ffn_half_step(x, layer: int, ffn_norm, ada_vec, s13, s2, w13, w2, *,
                  eps: float):
    """K5: one layer's FFN half on this shard's F rows.

    x [B, D] f32 (the residual after the attention sum); layer
    ``layer``'s ffn_norm, ada_vec [D], s13 [2 F_l] and s2 [D] f32 (g32:
    f16 group scales s13 [2 F_l, D/32], s2 [D, F_l/32]); the shard's
    stacks w13 [L, 2 F_l, D], w2 [L, D, F_l] int8.  Returns the W2
    partial [B, D] f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (``ffn_half_step.launches``, and
    ``ffn_half_step.g32_launches`` for g32).
    """
    dev = _device_of("ffn_half_step", x)
    if dev is None:
        return ffn_half_step_plain(x, layer, ffn_norm, ada_vec, s13, s2, w13,
                                   w2, eps=eps)
    B, D = x.shape
    L, F = w2.shape[0], w2.shape[2]
    if not (isinstance(layer, int) and 0 <= layer < L):
        raise ValueError(f"ffn_half_step: layer must be an int in [0, {L}), "
                         f"got {layer!r}")
    f32 = torch.float32
    g32 = _fmt(s13) == "g32"
    sdt = torch.float16 if g32 else f32
    _expect("ffn_half_step", dev, {
        "x": (x, f32, (B, D)), "ffn_norm": (ffn_norm, f32, (D,)),
        "ada_vec": (ada_vec, f32, (D,)),
        "s13": (s13, sdt, (2 * F, D // 32) if g32 else (2 * F,)),
        "s2": (s2, sdt, (D, F // 32) if g32 else (D,)),
        "w13": (w13, torch.int8, (L, 2 * F, D)),
        "w2": (w2, torch.int8, (L, D, F)),
    })
    if g32:
        _g32_ready("ffn_half_step", {"D": D, "F_l": F},
                   {"w13": w13, "w2": w2, "s13": s13, "s2": s2})
    fmt = "g32" if g32 else "w8"
    z = torch.empty((B, D), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        xq, sx, up = _scratch(dev, stream, ("K5", B, D, F), (
            ((B, max(D, F)), torch.int8), ((B,), f32), ((B, 2 * F), f32)))
        code = _entry("vx_ffn_half_step")(
            x.data_ptr(), z.data_ptr(), layer, ffn_norm.data_ptr(),
            ada_vec.data_ptr(), s13.data_ptr(), s2.data_ptr(),
            w13.data_ptr(), w2.data_ptr(), xq.data_ptr(), sx.data_ptr(),
            up.data_ptr(), B, D, F, int(g32), eps,
            tp_gemv_plan(fmt, B, "w13"), tp_gemv_plan(fmt, B, "w2"),
            int(TP_PDL), stream)
    check(code, "ffn_half_step")
    ffn_half_step.launches += 1
    ffn_half_step.g32_launches += int(g32)
    return z


ffn_half_step.launches = 0
ffn_half_step.g32_launches = 0


def lm_stream_plan(fmt: str, rows: int, V: int, D: int, sms: int) -> list:
    """K6's fold route: [kc, stages, grid] of K1's weight stream over a
    g32 vocab shard of V rows (``stream_plan``: from STREAM_MIN_ROWS
    ["g32"] rows, where it measured faster than lm_argmax.cuh's fold,
    benches/torch_tp_times.py --plans), else [0, 0, 0] (that fold: w8,
    or fewer rows)."""
    p = stream_plan(fmt, rows, V, D, sms) if fmt == "g32" else None
    return [p.kc, p.stages, p.grid] if p else [0, 0, 0]


def lm_half_argmax(x, final_norm, lm_scale_l, lm_codes_l, *, eps: float):
    """K6: this shard's greedy lm_head over its vocab rows.

    x [B, D] f32 (the stack's output); final_norm [D] f32; the shard's
    w8 table lm_codes_l [V_l, D] int8 and lm_scale_l [V_l] f32, or its
    g32 table (:func:`tp_shard_lm_head_q4g`) with f16 group scales
    lm_scale_l [V_l, D/32].  Returns (max logit [B, 1] f32, its first
    LOCAL index [B, 1] int32); the logits are never written.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise (``lm_half_argmax.launches``; ``lm_half_argmax.g32_launches``
    for g32, ``lm_half_argmax.stream_launches`` for a fold on K1's
    weight stream, :func:`lm_stream_plan`).
    """
    dev = _device_of("lm_half_argmax", x)
    if dev is None:
        return lm_half_argmax_plain(x, final_norm, lm_scale_l, lm_codes_l,
                                    eps=eps)
    B, D = x.shape
    V = lm_codes_l.shape[0]
    f32 = torch.float32
    g32 = _fmt(lm_scale_l) == "g32"
    _expect("lm_half_argmax", dev, {
        "x": (x, f32, (B, D)), "final_norm": (final_norm, f32, (D,)),
        "lm_codes_l": (lm_codes_l, torch.int8, (V, D)),
        "lm_scale_l": ((lm_scale_l, torch.float16, (V, D // 32)) if g32
                       else (lm_scale_l, f32, (V,))),
    })
    if g32:
        _g32_ready("lm_half_argmax", {"D": D},
                   {"lm_codes_l": lm_codes_l, "lm_scale_l": lm_scale_l})
    vmax = torch.empty((B, 1), dtype=f32, device=dev)
    vidx = torch.empty((B, 1), dtype=torch.int32, device=dev)
    plan = lm_stream_plan("g32" if g32 else "w8", B, V, D,
                          _sm_count(_card_index(dev)))
    tiles = -(-V // 16)  # the stream's groups of 16 rows (or LM_TILE's)
    xq = torch.empty((B, D), dtype=torch.int8, device=dev)
    sx = torch.empty((B,), dtype=f32, device=dev)
    tmax = torch.empty((B, tiles), dtype=f32, device=dev)
    tidx = torch.empty((B, tiles), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        fn = kernel_fn("vx_lm_half_argmax",
                       [_P] * 10 + [_I] * 4 + [_F, _P, _P])
        code = fn(x.data_ptr(), final_norm.data_ptr(), lm_codes_l.data_ptr(),
                  lm_scale_l.data_ptr(), vmax.data_ptr(), vidx.data_ptr(),
                  xq.data_ptr(), sx.data_ptr(), tmax.data_ptr(),
                  tidx.data_ptr(), B, D, V, int(g32), eps,
                  _plan_array(plan),
                  torch.cuda.current_stream(dev).cuda_stream)
    check(code, "lm_half_argmax")
    lm_half_argmax.launches += 1
    lm_half_argmax.g32_launches += int(g32)
    lm_half_argmax.stream_launches += int(plan[0] > 0)
    return vmax, vidx


lm_half_argmax.launches = 0
lm_half_argmax.g32_launches = 0
lm_half_argmax.stream_launches = 0


# ---------------------------------------------------------------------------
# Over the mesh
# ---------------------------------------------------------------------------


def tp_decode_step(
    mesh: Mesh, x, offsets,
    attn_norms, ffn_norms, ada_vecs, tp_w,
    cos_b, sin_b, k_cache: list, v_cache: list,
    k_scales: Optional[list] = None, v_scales: Optional[list] = None,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None, spec: int = 1,
    ring: Optional[tuple[int, int]] = None,
    cache_chunk: Optional[int] = None,
    attn=attn_half_step, ffn=ffn_half_step,
):
    """All decoder layers of one decode step, tensor-parallel (JAX
    ``tp_decode_step``, ``decode_tp_pallas.py:958-1107``).

    ``tp_w``: :func:`place_shards` of :func:`tp_shard_fused_weights`'
    stacks, or of :func:`tp_shard_fused_weights_q4g`'s (the g32 halves).  x [B, D] (B = streams x ``spec`` rows, ordered (stream,
    draft slot)), ``offsets`` an int or int32 [streams], cos_b / sin_b [hd] or per row [B, hd], the norm and
    ADA stacks [L, D] f32: replicated, moved to each shard's device (a
    no-op on a shared card).  ``k_cache`` / ``v_cache``: the grid
    ``[d][i]`` of the shards' head-major caches [L, streams_d, Hkv_l, S,
    hd] on their devices (JAX takes one array the partitioner shards),
    bf16, or int8 codes with the scale grids ``k_scales`` / ``v_scales``
    ``[d][i]`` of [L, streams_d, Hkv_l, S] f32 (k_new / v_new still come
    back bf16, for the caller to quantize and append, JAX's contract).
    ``ring``: the head+ring layout; ``cache_chunk``: the chunked walk
    (spec = 1; JAX's guards, ``:1008-1017``).  The streams split over the
    mesh's data axis (DP x TP when it is longer than 1: each data group
    runs its rows against its own model shards; the sums stay within a
    data group).  ``attn`` / ``ffn``: K4 and K5 (default) or their plain
    versions.

    Per layer and data group: K4 on each model shard, ``psum`` of the
    partials in shard order, the residual add, K5, ``psum``, the add.
    Returns (x_out [B, D] f32 on x's device, k_new, v_new: the grid
    ``[d][i]`` of [L, B_d, Hkv_l, hd] bf16 on the shards' devices, for
    the caller's appends; :func:`gather_kv` joins them).  ``B_d``: data
    group d's rows (its streams x ``spec``).
    """
    tp = mesh.shape[MODEL_AXIS]
    n_heads_l, n_kv_l = n_heads // tp, n_kv // tp
    B = x.shape[0]
    if (k_cache[0][0].dtype == torch.int8) and (k_scales is None
                                                or v_scales is None):
        raise ValueError("int8 KV cache needs k_scales/v_scales")
    if spec < 1 or B % spec:
        raise ValueError(f"spec={spec} must divide the row count {B}")
    if spec > 1 and cache_chunk:
        raise ValueError("speculative decode + cache_chunk unsupported")
    kw = dict(n_heads_l=n_heads_l, n_kv_l=n_kv_l, head_dim=head_dim,
              eps=eps, window=window, spec=spec, ring=ring,
              cache_chunk=cache_chunk)
    L = attn_norms.shape[0]
    x_out, kn, vn = [], [], []
    groups = row_groups(B // spec, mesh.shape[DATA_AXIS], spec)
    for d, rows in enumerate(groups):
        devs = mesh.devices[d]
        streams = slice(rows.start // spec, rows.stop // spec)
        w = [{k: v[d][i] for k, v in tp_w.items()} for i in range(tp)]
        offs = [offsets[streams].to(dev)
                if isinstance(offsets, torch.Tensor) else offsets
                for dev in devs]
        rope = [(cos_b[rows].to(dev), sin_b[rows].to(dev))
                if cos_b.dim() == 2 else (cos_b.to(dev), sin_b.to(dev))
                for dev in devs]
        vecs = [(attn_norms.float().to(dev), ffn_norms.float().to(dev),
                 ada_vecs.float().to(dev)) for dev in devs]
        xs = [x[rows].float().to(dev) for dev in devs]
        k_rows = [[] for _ in devs]
        v_rows = [[] for _ in devs]
        for l in range(L):
            ys = []
            for i, dev in enumerate(devs):
                scales = ((None, None) if k_scales is None else
                          (k_scales[d][i][l], v_scales[d][i][l]))
                y, k_l, v_l = attn(
                    xs[i], l, offs[i], vecs[i][0][l], w[i]["sqkv"][l],
                    w[i]["so"][l], *rope[i], k_cache[d][i][l],
                    v_cache[d][i][l], w[i]["wqkv"], w[i]["wo"], *scales,
                    **kw)
                ys.append(y)
                k_rows[i].append(k_l)
                v_rows[i].append(v_l)
            xs = [xi + yi for xi, yi in zip(xs, psum(ys, devs))]
            zs = [ffn(xs[i], l, vecs[i][1][l], vecs[i][2][l],
                      w[i]["s13"][l], w[i]["s2"][l], w[i]["w13"],
                      w[i]["w2"], eps=eps) for i in range(tp)]
            xs = [xi + zi for xi, zi in zip(xs, psum(zs, devs))]
        x_out.append(xs[0].to(x.device))
        kn.append([torch.stack(r) for r in k_rows])
        vn.append([torch.stack(r) for r in v_rows])
    return torch.cat(x_out), kn, vn


def tp_lm_head_token(mesh: Mesh, x, final_norm, lm_codes_sh, lm_scale_sh,
                     *, eps: float, half=lm_half_argmax):
    """The greedy token from a vocab-sharded tied lm_head, [B] int32 on
    x's device (JAX ``tp_lm_head_token``, ``:1385-1424``): K6 on each
    model shard, then ``collectives.argmax_resolve`` (the largest value,
    then the lowest global index: ``torch.argmax``'s first index).
    ``lm_codes_sh`` / ``lm_scale_sh``: :func:`place_shards` of
    :func:`tp_shard_lm_head`'s leaves (or :func:`tp_shard_lm_head_q4g`'s:
    K6 over g32 shards).  The rows split over the data
    axis as in :func:`tp_decode_step`.  ``half``: K6 (default) or its
    plain version."""
    toks = []
    for d, rows in enumerate(row_groups(x.shape[0], mesh.shape[DATA_AXIS])):
        vals, idxs = [], []
        for i, dev in enumerate(mesh.devices[d]):
            codes = lm_codes_sh[d][i]
            v, j = half(x[rows].float().to(dev), final_norm.float().to(dev),
                        lm_scale_sh[d][i], codes, eps=eps)
            vals.append(v)
            idxs.append(j)
        toks.append(argmax_resolve(vals, idxs, codes.shape[0]).to(x.device))
    return torch.cat(toks)
