"""K1: the whole decode step, hand-written CUDA for Hopper.

Replaces ``voxtral_tpu/ops/decode_step_pallas.py::decode_stack_step``
(kernel body ``_make_stack_kernel``) in its modes (a) w8 weights, bf16
bounded head-major cache, sliding window, final norm + tied lm_head
folded into logits; (b) ``spec=K`` speculative verification, K draft
rows per stream in one pass over the weights; (c) per-stream offsets
(an int32 device vector) and per-row RoPE vectors; (h) g32 (q4g)
weights — int8 codes = Q4_0 nibble - 8 with their f16 group scales
[L, N, K/32] in place of the row scales (the JAX ``[L, SB, N, 128]`` /
``[L, 4 SB, 1, N]`` f32 layouts exist for Mosaic; the port keeps the w8
code layout and the exact f16 scales, 1.0625 bytes per weight), for
the stacks and the lm fold, combinable with (b) and (c); (d) the
head+ring cache of an unbounded stream (``ring=(head, size)``): slots
[0, head) hold positions [0, head) for good, ring slot r the largest
position head + r + size * c below the offset; the attention walks all
S slots in slot order and masks each by its absolute position, as the
JAX ``build_valid`` (``decode_step_pallas.py:1020-1042``, spec rows
``:813-829``), combinable with every other mode; (e) the int8 KV cache
(``k_scales`` / ``v_scales``: int8 codes with one f32 scale per cached
vector, ``scores_of`` / ``ctx_of`` ``:1045-1080`` and the spec branch's
fresh-row roundtrip ``:831-929``): integer score and P.V dots, the
softmax weights requantized in one group per row; (f) the chunked cache
(``cache_chunk=Sc``, ``:1085-1180``): an online softmax over the chunks
some row of the batch can see, in slot order, so the score buffer holds
Sc floats and shared memory no longer bounds S; (g) bf16 weights
(``wq8=False``, ``:558``, ``:667-677``, ``:742-752``, the lm fold
``:1274-1281``): the dense ``{"nt": w}`` leaves of
:func:`fuse_decode_weights_bf16` streamed as they are (the qkv stack as
the segments (wq, wk, wv), the FFN's as (w1, w3)), each linear's input
row cast to bf16 instead of quantized, bf16 x bf16 products summed in
f32 (here f64, rounded once) with no scales, the folded lm_head over
the dense bf16 table; combinable with every cache mode; (i)
``lm_argmax`` (``:1271-1300``, over a w8, g32 or bf16 table): the greedy
argmax folded into the lm_head, a running (max, first index) over vocab
tiles, so the step returns each row's token and never writes the
logits; over each table the fold compares the logits of that weight
mode bit for bit (the same row dots), so its token is ``torch.argmax``
of them.  Source:
``csrc/decode_step.cu`` (the weight stream: ``csrc/k1_stream.cuh``;
the one-row GEMV of mode (g): ``csrc/bf16_gemv.cuh``; the fold of mode
(i): ``csrc/lm_argmax.cuh`` or the stream's).

What bounds it on the H100: the int8 weights streamed once per step —
26 layers of wqkv / wo / w13 / w2 plus the 131072 x 3072 lm table, about
3.4 GB at full width (3.64 GB with g32 scales, 6.86 GB of bf16 in mode
(g)), shared by every row of the step (up to 64 rows per weight pass).
The design: a fixed sequence of kernels on the current stream (row norm
+ int8 quant, the weight stream of each linear, the RoPE + GQA
attention, residual adds fused into the GEMV epilogue) — 9 launches per
layer + 2, no cross-block carry.  :func:`stream_plan` picks each
linear's GEMV: the weight stream (persistent blocks, a cp.async ring per
warp, bf16 products on the f64 tensor cores; :func:`bf16_dots_split_plain`
states its summation order) for bf16 from 2 rows, g32 from 5 (one
int8 mma a group, f64 group sums) and w8 above 32
(:data:`STREAM_MIN_ROWS`), else ``__dp4a`` (up to 8 rows), int8
tensor-core ``mma`` (up to 64) or
``bf16_row_dots`` (one bf16 row).  A one-row step and a stream step go
out as programmatic dependent launches (:data:`K1_PDL`).  The attention of modes
(a)-(e) is one thread-block cluster per (stream, kv head): its blocks
split the visible slots, serve every query head and draft row of the
stream (one read of each K/V row), and merge max, denominators and P.V
through distributed shared memory (``csrc/attn_step.cuh``,
:func:`attention_split_plain` states its arithmetic); mode (f) runs on
the same walk, the chunks' running max formed from the blocks' piece
maxima before any exponential and the chunks folded in order, each
block over a slice of the dims (:func:`attention_chunk_split_plain`).
The blocks
read the offsets on the device, so a step launches without a host
sync.  One call of the wrapper is one step and counts as one launch in
``decode_stack_step.launches``.

With a full window the attention reads as many bytes as the weights at
four streams (0.87 GB of bf16 cache per stream and step); mode (e)
halves them (int8 codes + 1/32 of that in scales).

Also here, K7 (:func:`decode_layer_step`, ``csrc/decode_layer.cu``): one
decoder layer of the w8 step over the position-major prefill cache
[B, S, Hkv, hd] with a scalar offset (JAX ``decode_layer_step``), which
the one-shot path's per-layer route calls once per layer and position
(``models.voxtral.oneshot_plan``): nine programmatic dependent launches
(:data:`K7_PDL`), the attention a block or a cluster per (row, kv head)
serving its query heads (:func:`layer_attn_plan`;
:func:`layer_attention_split_plain` states the split walk's
arithmetic); and the host-side preparation the JAX
module holds beside the kernels: :func:`fuse_decode_weights`, :func:`fuse_decode_weights_q4g`,
:func:`fuse_decode_weights_bf16`, :func:`megakernel_mode`, :func:`q4g_geometry_ok`, :func:`ada_vectors`,
:func:`rope_pair_vectors` and :func:`quantize_kv`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from voxtral_tpu_torch.models.layers import ring_k_positions
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


def fuse_decode_weights_q4g(decoder_params: Params) -> Params:
    """The step's g32 (mode (h)) stacks from unpacked q4 decoder params.

    The unpacked leaves ({"codes": int8 [L, N, K], "scales": f16
    [L, N, K/32]}) are the exact group-32 re-encoding of Q4_0, so the
    step computes with Q4_0's own weights.  Returns wqkv / wo / w13 / w2
    int8 [L, N, K] with f16 group-scale stacks sqkv / so / s13 / s2
    [L, N, K/32], the f32 norm stacks, and lm_codes [V, D] / lm_scale
    [V, D/32] when the token-embedding table is an unpacked q4 leaf (the
    tied lm_head folds into the step).
    """
    lyr = decoder_params["layers"]
    att, ffn = lyr["attention"], lyr["ffn"]

    def parts(leaf):
        q4 = leaf["q4"]
        if "codes" not in q4:
            raise ValueError(
                "q4g fusing needs unpacked q4 leaves (codes + f16 scales); "
                "packed codes carry bf16-rounded scales and stay per-op "
                "(load with weight_format=\"q4g\")")
        return q4["codes"], q4["scales"]

    def codes(*leaves):
        return torch.cat([parts(x)[0] for x in leaves], dim=1).contiguous()

    def scales(*leaves):
        return torch.cat([parts(x)[1] for x in leaves],
                         dim=1).to(torch.float16).contiguous()

    out = {
        "wqkv": codes(att["wq"], att["wk"], att["wv"]),
        "sqkv": scales(att["wq"], att["wk"], att["wv"]),
        "wo": codes(att["wo"]), "so": scales(att["wo"]),
        "w13": codes(ffn["w1"], ffn["w3"]),
        "s13": scales(ffn["w1"], ffn["w3"]),
        "w2": codes(ffn["w2"]), "s2": scales(ffn["w2"]),
        "attn_norm": lyr["attention_norm"].float(),
        "ffn_norm": lyr["ffn_norm"].float(),
    }
    emb = decoder_params.get("tok_embeddings")
    if isinstance(emb, dict) and "q4" in emb and "codes" in emb["q4"]:
        out["lm_codes"] = emb["q4"]["codes"].contiguous()
        out["lm_scale"] = emb["q4"]["scales"].to(torch.float16).contiguous()
    return out


def fuse_decode_weights_bf16(decoder_params: Params) -> Params:
    """The step's mode (g) stacks from dense decoder params, memory-
    neutrally (JAX ``fuse_decode_weights_bf16``).

    Each dense [L, K, N] leaf of the attention and the FFN is transposed
    once to the kernel's [L, N, K] bf16 layout and replaces the original
    in ``decoder_params`` as ``{"nt": w}``, which the prefill's linears
    contract directly (``models.layers.linear``), so the decoder weights
    exist once: the original is freed leaf by leaf, and the peak extra
    memory is one transposed leaf.  The returned dict references the same
    tensors: ``wqkv`` = (wq, wk, wv), ``w13`` = (w1, w3), ``wo``, ``w2``;
    the scale keys are None (dense weights carry no scales); the f32 norm
    stacks.  Leaves already rewritten are taken as they are.
    """
    lyr = decoder_params["layers"]
    att, ffn = lyr["attention"], lyr["ffn"]

    def nt(leaves, name):
        w = leaves[name]
        if isinstance(w, dict):  # already rewritten
            return w["nt"]
        wt = w.transpose(1, 2).to(torch.bfloat16).contiguous()
        leaves[name] = {"nt": wt}  # drops the tree's [L, K, N] original
        return wt

    wqkv = (nt(att, "wq"), nt(att, "wk"), nt(att, "wv"))
    wo = nt(att, "wo")
    w13 = (nt(ffn, "w1"), nt(ffn, "w3"))
    w2 = nt(ffn, "w2")
    return {
        "wqkv": wqkv, "sqkv": None, "wo": wo, "so": None,
        "w13": w13, "s13": None, "w2": w2, "s2": None,
        "attn_norm": lyr["attention_norm"].float(),
        "ffn_norm": lyr["ffn_norm"].float(),
    }


def q4g_geometry_ok(lm_cfg) -> bool:
    """g32 mode needs every streamed contraction dim % 128 == 0 (the JAX
    gate, kept so both packages route the same models to mode (h))."""
    nq = lm_cfg.n_heads * lm_cfg.head_dim
    return not (lm_cfg.dim % 128 or nq % 128 or lm_cfg.hidden_dim % 128)


def megakernel_mode(decoder_params: Params, head_dim: int):
    """Which stack-step weight mode this model supports, as the JAX
    function decides it: "w8" (rowwise-int8 leaves), "q4g" (unpacked q4
    leaves), "bf16" (dense bf16 leaves, or ``{"nt": w}`` leaves already
    rewritten: mode (g)), or None (packed q4 leaves, dense f32 leaves,
    odd head_dim — the per-op decode step)."""
    if head_dim % 2:
        return None
    lyr = decoder_params.get("layers", {})
    att, ffn = lyr.get("attention", {}), lyr.get("ffn", {})
    wq, w1 = att.get("wq"), ffn.get("w1")
    if wq is None or w1 is None:
        return None
    if isinstance(wq, dict):
        if "w8" in wq and isinstance(w1, dict) and "w8" in w1:
            return "w8"
        if "nt" in wq and isinstance(w1, dict) and "nt" in w1:
            return "bf16"
        if ("q4" in wq and isinstance(w1, dict) and "q4" in w1
                and "codes" in wq["q4"] and "codes" in w1["q4"]
                and wq["q4"]["codes"].shape[-1] % 128 == 0
                and w1["q4"]["codes"].shape[-1] % 128 == 0):
            return "q4g"
        return None
    if wq.dtype == torch.bfloat16 and not isinstance(w1, dict):
        return "bf16"
    return None


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


def _absmax_codes(t: torch.Tensor, floor: float):
    """Per-vector symmetric int8 quantization over the last axis:
    s = max(absmax, floor) / 127 (a true division: by a tensor, since
    CUDA PyTorch multiplies by the reciprocal of a Python scalar) and
    the codes clip(round_half_even(t / s), -127, 127) as floats.
    -> (codes, s [..., 1])."""
    a = t.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(a, min=floor) / torch.full_like(a, 127.0)
    return torch.clamp(torch.round(t / s), -127, 127), s


def quantize_kv(vecs: torch.Tensor):
    """Per-vector int8 quantization of K / V rows for the int8 cache
    (mode (e)): vecs [..., hd] -> (codes int8 [..., hd], scales f32
    [...]).  Used for the prefilled cache and for k_new / v_new at each
    append (JAX ``quantize_kv``)."""
    q, s = _absmax_codes(vecs.float(), 1e-8)
    return q.to(torch.int8), s[..., 0]


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
    """(x * (1 / sqrt(mean(x^2) + eps))) * w, mean(x^2) in f64.  The
    count divides as a tensor: a true division on every device (CUDA
    PyTorch turns a division by a Python scalar into a multiplication by
    its reciprocal)."""
    xd = x.double()
    ss = (xd * xd).sum(dim=-1, keepdim=True)
    var = (ss / torch.full_like(ss, x.shape[-1])).float()
    return x * (1.0 / torch.sqrt(var + eps)) * w


def g32_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's group-32 GEMV: xq [M, K] int8, sx
    [M, 1], codes [N, K] int8, scales [N, K/32] f16 -> [M, N] f32 =
    float(sum_g z_g * s_g) * sx, the exact group dots z_g and the sum
    over the groups in f64 (rounded once, as the kernel).  Each group dot
    is an integer below 32 x 127 x 8 < 2^24, so the f32 product computes
    it exactly, in any order (TF32 too: 8-bit codes fit its mantissa).
    Each z_g * s_g has at most 26 significant bits, so a row's f64 sum is
    exact in any order while its scales span fewer than about 18
    binades: then K1's weight stream (``csrc/k1_stream.cuh``: even and
    odd groups in two chains, chunk by chunk, the K parts in order) and
    the one-row GEMV (``g32_row_dots``) give this sum bit for bit.  Past
    that span the orders may round differently."""
    m, k = xq.shape
    n, g = codes.shape[0], k // 32
    xg = xq.float().reshape(m, g, 32).transpose(0, 1)  # [G, M, 32]
    out = []
    for n0 in range(0, n, _G32_CHUNK):  # bounds the [G, M, chunk] product
        cg = codes[n0:n0 + _G32_CHUNK].float().reshape(-1, g, 32)
        z = torch.bmm(xg, cg.permute(1, 2, 0))  # [G, M, chunk], exact
        s = scales[n0:n0 + _G32_CHUNK].double().T[:, None, :]
        out.append((z.double() * s).sum(dim=0).float())
    return torch.cat(out, dim=1) * sx.reshape(-1, 1).float()


_G32_CHUNK = 8192


def bf16_matmul_plain(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of mode (g)'s GEMV: xb [M, K] bf16, w [N, K] bf16 ->
    [M, N] f32, the exact bf16 x bf16 products summed in f64 and rounded
    once (as the kernel), over blocks of output rows (bounds the f64 copy
    of the weights)."""
    xd = xb.double()
    return torch.cat([(xd @ w[n0:n0 + _G32_CHUNK].double().T).float()
                      for n0 in range(0, w.shape[0], _G32_CHUNK)], dim=1)


def bf16_dots_split_plain(xb: torch.Tensor, w: torch.Tensor,
                          kc: Optional[int] = None) -> torch.Tensor:
    """Mode (g)'s GEMV in the summation order of K1's weight stream
    (``csrc/k1_stream.cuh``): xb [M, K] bf16, w [N, K] bf16 -> [M, N] f32.
    K splits into STREAM_PARTS parts and each part into chunks of ``kc``
    elements (default: :func:`stream_chunk` of K); every chunk's exact
    bf16 x bf16 products are summed in f64, the chunks of a part added
    in k order, the parts in part order, and the sum rounds once to f32.
    The kernel sums each chunk in (step, slot) order inside the f64
    tensor cores; the value differs from :func:`bf16_matmul_plain`'s
    only by f64 round-off, and the row count enters nowhere."""
    m, k = xb.shape
    kc = kc or stream_chunk("bf16", k)
    if not kc:
        raise ValueError(f"the weight stream does not take K = {k}")
    xd = xb.double()
    total = None
    part_k = k // STREAM_PARTS
    for p in range(STREAM_PARTS):
        part = None
        for k0 in range(p * part_k, (p + 1) * part_k, kc):
            cols = []
            for n0 in range(0, w.shape[0], _G32_CHUNK):
                wc = w[n0:n0 + _G32_CHUNK, k0:k0 + kc].double()
                cols.append(xd[:, k0:k0 + kc] @ wc.T)
            chunk = torch.cat(cols, dim=1)
            part = chunk if part is None else part + chunk
        total = part if total is None else total + part
    return total.float()


def _segs(w) -> tuple:
    """A stack as its tuple of segments (mode (g) may split qkv / w13)."""
    return w if isinstance(w, tuple) else (w,)


def _layer(w, l: int):
    """Layer l of a stack or of each of its segments."""
    return tuple(t[l] for t in w) if isinstance(w, tuple) else w[l]


def _linear_plain(h, w, scales, fmt: str) -> torch.Tensor:
    """One streamed linear of the step on rows h [M, K] f32 -> [M, N] f32:
    W8A8 (row scales [N]), group-32 (scales [N, K/32]) or, in mode (g),
    h cast to bf16 against the dense bf16 segments."""
    if fmt == "bf16":
        xb = h.to(torch.bfloat16)
        return torch.cat([bf16_matmul_plain(xb, t) for t in _segs(w)],
                         dim=1)
    xq, sx = _quant(h)
    if fmt == "g32":
        return g32_matmul_plain(xq, sx, w, scales)
    return w8_matmul_plain(xq, sx, w, scales)


def _spec_streams(rows: int, cache_rows: int, spec: int) -> int:
    """The stream count Bc = rows / spec; ValueError as the JAX wrapper."""
    if spec < 1:
        raise ValueError(f"spec must be >= 1, got {spec}")
    if rows % spec:
        raise ValueError(f"spec={spec} must divide the row count {rows}")
    if cache_rows != rows // spec:
        raise ValueError(
            f"cache rows {cache_rows} != streams {rows // spec} (= B/spec)")
    return rows // spec


def _chunk_range(offs, S: int, window, ring, chunk: int):
    """Chunks [c_lo, n_used) a chunked step walks: those some row of the
    batch can see (JAX ``:1106-1119``).  Reads the offsets' min and max
    (the plain version only; the kernel reads them on the device)."""
    mn, mx = int(offs.min()), int(offs.max())
    if ring is None:
        used = mx
        lo_pos = max(mn - window, 0) if window is not None else 0
    else:
        used, lo_pos = min(mx, ring[0] + ring[1]), 0
    return lo_pos // chunk, min(-(-used // chunk), S // chunk)


def _attention_plain(q, k, v, k_cache, v_cache, offs, window, spec, n_kv,
                     scale, ring=None, k_scales=None, v_scales=None,
                     cache_chunk=None):
    """One layer's attention, as the JAX kernel computes it (its spec
    branch for spec > 1): q [B, H, hd], k / v [B, Hkv, hd] RoPE'd f32;
    caches [Bc, Hkv, S, hd] bf16, or int8 with ``k_scales`` / ``v_scales``
    [Bc, Hkv, S] (mode (e)); offs [Bc] int; ``ring`` the head+ring layout
    (mode (d)) or None; ``cache_chunk`` the online softmax over chunks
    (mode (f), spec = 1).  -> [B, H * hd]."""
    B, n_heads, hd = q.shape
    Bc, S = B // spec, k_cache.shape[2]
    groups = n_heads // n_kv
    int8 = k_scales is not None
    qS = q.reshape(Bc, spec, n_heads, hd)
    kS = k.reshape(Bc, spec, n_kv, hd)
    vS = v.reshape(Bc, spec, n_kv, hd)
    kc = k_cache.reshape(Bc * n_kv, S, hd).double()
    vc = v_cache.reshape(Bc * n_kv, S, hd).double()
    off = offs.reshape(Bc, 1).long()
    if ring is None:
        p_abs = torch.arange(S, device=off.device)
        written = p_abs < off
    else:
        p_abs, written = ring_k_positions(*ring, off, slots=S)
    if int8:
        ks = k_scales.reshape(Bc * n_kv, S)
        vs = v_scales.reshape(Bc * n_kv, S)
        # Fresh rows read as the sequential step reads them back from the
        # int8 cache: through bf16 and the per-vector quantization.
        kqf, ksf = _absmax_codes(kS.to(torch.bfloat16).float(), 1e-8)
        vqf, vsf = _absmax_codes(vS.to(torch.bfloat16).float(), 1e-8)

    def fresh(t, i):  # [Bc, spec, Hkv, n] -> row i's [Bc * Hkv, 1, n]
        return t[:, i].reshape(Bc * n_kv, 1, t.shape[-1])

    def scores_of(qj, qq, sq, sl, valid):
        """Masked scores of the cache slots ``sl`` [Bc * Hkv, G, n]."""
        if int8:
            z = (qq.double() @ kc[:, sl].transpose(1, 2)).float()
            sj = z * sq * ks[:, None, sl]
        else:
            sj = (qj.to(k_cache.dtype).double()
                  @ kc[:, sl].transpose(1, 2)).float()
        return torch.where(valid[:, None, sl], sj, float("-inf"))

    def requant(e_w, extra=()):
        """(codes, se) of softmax weights x v scales, one group per row
        over ``e_w``'s slots and the ``extra`` [Bc * Hkv, G] weights."""
        ea = e_w.abs().amax(dim=-1, keepdim=True)
        for ew_i in extra:
            ea = torch.maximum(ea, ew_i.abs()[..., None])
        se = torch.clamp(ea, min=1e-30) / torch.full_like(ea, 127.0)
        return torch.clamp(torch.round(e_w / se), -127, 127), se

    def ctx_of(e, sl, extra=()):
        """Softmax weights x V over the slots ``sl`` -> (ctx, se)."""
        if int8:
            eq, se = requant(e * vs[:, None, sl], extra)
            return (eq.double() @ vc[:, sl]).float() * se, se
        return (e.to(v_cache.dtype).double() @ vc[:, sl]).float(), None

    rows = []
    for j in range(spec):
        qj = qS[:, j].reshape(Bc * n_kv, groups, hd) * scale
        qq, sq = _absmax_codes(qj, 1e-8) if int8 else (None, None)
        valid = written
        if window is not None:
            valid = valid & ((off + j - p_abs) <= window)
        valid = valid.repeat_interleave(n_kv, dim=0)
        s_self = _sum64(qj.double() * fresh(kS, j).double())
        if cache_chunk:
            m = torch.full_like(s_self, -1e30)
            denom = torch.zeros_like(s_self)
            ctx = torch.zeros_like(qj)
            for c in range(*_chunk_range(offs, S, window, ring,
                                         cache_chunk)):
                sl = slice(c * cache_chunk, (c + 1) * cache_chunk)
                sj = scores_of(qj, qq, sq, sl, valid)
                m_new = torch.maximum(m, sj.amax(-1))
                alpha = torch.exp(m - m_new)
                e = torch.exp(sj - m_new[..., None])
                denom = denom * alpha + _sum64(e)
                ctx = ctx * alpha[..., None] + ctx_of(e, sl)[0]
                m = m_new
            m_f = torch.maximum(m, s_self)
            alpha = torch.exp(m - m_f)
            e_self = torch.exp(s_self - m_f)
            denom = denom * alpha + e_self
            ctx = ctx * alpha[..., None] + e_self[..., None] * fresh(vS, j)
            rows.append((ctx / denom[..., None]).reshape(Bc, n_heads * hd))
            continue
        sj = scores_of(qj, qq, sq, slice(None), valid)
        prevs = []
        for i in range(j):
            if window is not None and j - i > window:
                continue
            if int8:
                z = _sum64(qq.double() * fresh(kqf, i).double())
                si = z * sq[..., 0] * fresh(ksf, i)[..., 0]
            else:
                si = _sum64(qj.double() * fresh(kS, i).double())
            prevs.append((i, si))
        m = torch.maximum(sj.amax(-1), s_self)
        for _, si in prevs:
            m = torch.maximum(m, si)
        e_cache = torch.exp(sj - m[..., None])
        denom = _sum64(e_cache)
        e_fresh = [(i, torch.exp(si - m)) for i, si in prevs]
        if int8:
            # One requant group over the cache slots and the fresh rows.
            ew = [e_i * fresh(vsf, i)[..., 0] for i, e_i in e_fresh]
            ctx, se = ctx_of(e_cache, slice(None), ew)
            for (i, e_i), ew_i in zip(e_fresh, ew):
                denom = denom + e_i
                eqi = torch.clamp(torch.round(ew_i / se[..., 0]), -127, 127)
                ctx = ctx + eqi[..., None] * fresh(vqf, i) * se
        else:
            ctx, _ = ctx_of(e_cache, slice(None))
            for i, e_i in e_fresh:
                denom = denom + e_i
                ctx = ctx + e_i[..., None] * fresh(vS, i)
        e_self = torch.exp(s_self - m)
        denom = denom + e_self
        ctx = ctx + e_self[..., None] * fresh(vS, j)
        rows.append((ctx / denom[..., None]).reshape(Bc, n_heads * hd))
    return torch.stack(rows, dim=1).reshape(B, n_heads * hd)


def attention_split_plain(q, k, v, k_cache, v_cache, offs, window, spec,
                          n_kv, scale, cluster: int, ring=None,
                          k_scales=None, v_scales=None):
    """What the cluster walk of K1 / K4 computes (``csrc/attn_step.cuh``
    ``attn_cluster_kernel``), written plainly: the arguments of
    :func:`_attention_plain` (no chunked walk), and ``cluster`` = C.

    For each stream b and kv head, over all G x spec query vectors at
    once: the slots some row can see ([max(0, off - window), min(off,
    S)) bounded; the written head and ring slots on a head+ring cache)
    cut into C contiguous pieces of ceil(n / C) slots (pieces past the
    end empty); per piece the masked scores, their max (piece 0 also the
    self and fresh scores), and after the global max the f64 sum of
    expf(s - m) and the P.V partial (bf16 weights x bf16 v in f64, or,
    int8, the weights x v scales requantized with the group's se from
    the pieces' absmax and the fresh rows', int8 x int8); the partials
    added in piece order, each rounded once, then the fresh and self
    terms in f32 as :func:`_attention_plain` adds them.  Nothing on the
    main path calls it; ``tests/test_torch_attn_split.py`` holds it to
    :func:`_attention_plain` bit for bit.  -> [B, H * hd]."""
    B, n_heads, hd = q.shape
    Bc, S = B // spec, k_cache.shape[2]
    G = n_heads // n_kv
    int8 = k_scales is not None
    qs = q * scale
    if int8:
        kqf, ksf = _absmax_codes(k.to(torch.bfloat16).float(), 1e-8)
        vqf, vsf = _absmax_codes(v.to(torch.bfloat16).float(), 1e-8)
    out = torch.empty((B, n_heads, hd), dtype=torch.float32,
                      device=q.device)
    js = torch.arange(spec, device=q.device).repeat_interleave(G)  # [V]
    for b in range(Bc):
        off = int(offs[b])
        if ring is None:
            lo = max(0, off - window) if window is not None else 0
            hi = min(off, S)
        else:
            head, size = ring
            lo, hi = 0, off if off < head else head + min(size, off - head)
        n = max(hi - lo, 0)
        slots = torch.arange(lo, lo + n, device=q.device)
        if ring is None:
            p_abs, written = slots, slots < off
        else:
            p_abs, written = ring_k_positions(*ring, off, device=q.device,
                                              slots=S)
            p_abs, written = p_abs[lo:lo + n], written[lo:lo + n]
        vis = written[None, :].expand(spec * G, n)
        if window is not None:
            vis = vis & ((off + js[:, None] - p_abs[None, :]) <= window)
        rows = b * spec + js  # [V]
        for jh in range(n_kv):
            heads = jh * G + torch.arange(G, device=q.device).repeat(spec)
            qv = qs[rows, heads]  # [V, hd] f32
            kc = k_cache[b, jh, lo:lo + n].double()
            vc = v_cache[b, jh, lo:lo + n].double()
            if int8:
                qq, sq = _absmax_codes(qv, 1e-8)
                sc = ((qq.double() @ kc.T).float() * sq
                      * k_scales[b, jh, lo:lo + n])
            else:
                sc = (qv.to(torch.bfloat16).double() @ kc.T).float()
            sc = torch.where(vis, sc, float("-inf"))
            s_self = _sum64(qv.double() * k[rows, jh].double())
            fresh = torch.full((spec * G, spec), float("-inf"),
                               device=q.device)
            for vi in range(spec * G):
                j = int(js[vi])
                for i in range(j):
                    if window is not None and j - i > window:
                        continue
                    ri = b * spec + i
                    if int8:
                        z = _sum64(qq[vi].double() * kqf[ri, jh].double())
                        fresh[vi, i] = z * sq[vi, 0] * ksf[ri, jh, 0]
                    else:
                        fresh[vi, i] = _sum64(qv[vi].double()
                                              * k[ri, jh].double())
            ln = -(-n // cluster)
            pieces = [slice(min(c * ln, n), min(c * ln + ln, n))
                      for c in range(cluster)]
            m_piece = [sc[:, p].amax(-1) if p.stop > p.start else
                       torch.full_like(s_self, float("-inf"))
                       for p in pieces]
            m_piece[0] = torch.maximum(
                torch.maximum(m_piece[0], s_self), fresh.amax(-1))
            m = m_piece[0]
            for mp in m_piece[1:]:
                m = torch.maximum(m, mp)
            e = torch.exp(sc - m[:, None])
            e_fresh = torch.exp(fresh - m[:, None])  # 0 where not fresh
            e_self = torch.exp(s_self - m)
            dens = [e[:, p].double().sum(-1) for p in pieces]
            if int8:
                vs = v_scales[b, jh, lo:lo + n]
                ew = torch.where(vis, e * vs, torch.zeros_like(e))
                ea = torch.stack([ew[:, p].abs().amax(-1) if p.stop > p.start
                                  else torch.zeros_like(s_self)
                                  for p in pieces]).amax(0)
                ewf = e_fresh * vsf[b * spec:(b + 1) * spec, jh, 0]
                ea = torch.maximum(ea, ewf.abs().amax(-1))
                se = torch.clamp(ea, min=1e-30) / torch.full_like(ea, 127.0)
                w = torch.clamp(torch.round(ew / se[:, None]), -127, 127)
            else:
                w = e.to(torch.bfloat16)
            pvs = [w[:, p].double() @ vc[p] for p in pieces]
            den, pv = dens[0], pvs[0]
            for d_, p_ in zip(dens[1:], pvs[1:]):
                den, pv = den + d_, pv + p_
            den, ctx = den.float(), pv.float()
            if int8:
                ctx = ctx * se[:, None]
            for vi in range(spec * G):
                j = int(js[vi])
                for i in range(j):
                    if window is not None and j - i > window:
                        continue
                    ri = b * spec + i
                    den[vi] = den[vi] + e_fresh[vi, i]
                    if int8:
                        eqi = torch.clamp(torch.round(ewf[vi, i] / se[vi]),
                                          -127, 127)
                        ctx[vi] = ctx[vi] + eqi * vqf[ri, jh] * se[vi]
                    else:
                        ctx[vi] = ctx[vi] + e_fresh[vi, i] * v[ri, jh]
            den = den + e_self
            ctx = ctx + e_self[:, None] * v[rows, jh]
            out[rows, heads] = ctx / den[:, None]
    return out.reshape(B, n_heads * hd)


# Cache rows a staged tile of the attention kernels holds (attn_step.cuh:
# kTileSlots); mode (f)'s pieces are whole tiles.
ATTN_TILE = 64


def _chunk_walk_pieces(lo: int, hi: int, chunk: int, cluster: int,
                      round_chunks: int, tile: int = ATTN_TILE) -> list:
    """The chunked cluster walk's partition of one stream's visible slots
    [lo, hi) (``csrc/attn_step.cuh`` ``attn_chunk_kernel``): rounds of
    ``round_chunks`` whole chunks of ``chunk`` slots, each round's slots
    cut into ``cluster`` contiguous pieces of ceil(n / C) slots rounded up
    to whole tiles of ``tile`` slots (the kernel's ATTN_TILE; pieces past
    the end empty).
    -> [(round's first chunk, its end chunk, [(piece start, end)] * C)]."""
    rounds = []
    if hi <= lo:
        return rounds
    c_end = -(-hi // chunk)
    for ca in range(lo // chunk, c_end, round_chunks):
        cb = min(ca + round_chunks, c_end)
        ra, rb = max(lo, ca * chunk), min(hi, cb * chunk)
        ln = -(-(-(-(rb - ra) // cluster)) // tile) * tile
        rounds.append((ca, cb, [(min(ra + i * ln, rb),
                                 min(ra + (i + 1) * ln, rb))
                                for i in range(cluster)]))
    return rounds


def attention_chunk_split_plain(q, k, v, k_cache, v_cache, offs, window,
                                n_kv, scale, cache_chunk: int, cluster: int,
                                ring=None, k_scales=None, v_scales=None,
                                round_chunks: Optional[int] = None,
                                tile: int = ATTN_TILE):
    """What mode (f)'s cluster walk of K1 / K4 computes (``csrc/
    attn_step.cuh`` ``attn_chunk_kernel``), written plainly: the
    arguments of :func:`_attention_plain` with spec = 1 and its chunked
    branch (``cache_chunk``), ``cluster`` = C blocks, ``round_chunks``
    chunks a round (default: all of a stream's in one round), pieces in
    whole tiles of ``tile`` slots (a smaller tile splits a short cache).

    Per stream and kv head, over its G query heads at once, and only over
    the stream's own visible slots ([max(0, off - window), min(off, S))
    bounded, the written slots [0, min(off, head + size)) of a head+ring
    cache; :func:`_chunk_walk_pieces` cuts them): per piece the masked
    scores, their max M and the max F of its first chunk's slots.  A
    chunk's running max m_c is the max of -1e30 and every visible slot
    before the chunk's end, in any order: a piece forms it from the
    pieces before it (their M; earlier rounds' through the carry), its
    own chunks in order and, for its last chunk, the later pieces that
    chunk reaches (their F).  Given m_c each chunk's e = expf(s - m_c),
    its bf16 weights or (int8) its requant group se_c from the absmax of
    its pieces' weights x v scales, its f64 denominator and P.V partial
    per piece, are independent of the other chunks.  The partials are
    added in piece order and rounded once, then folded in chunk order in
    f32 exactly as :func:`_attention_plain`: alpha = expf(m_{c-1} -
    m_c), den = den alpha + den_c, ctx = ctx alpha + pv_c; the self term
    last.  A chunk the row sees nothing of is an identity in that fold
    (alpha 1, sums 0), so walking the stream's chunks and not the
    batch's (JAX ``:1106-1119``) changes no bit.  Nothing on the main
    path calls it; ``tests/test_torch_attn_split.py`` holds it to
    :func:`_attention_plain` bit for bit.  -> [B, H * hd]."""
    B, n_heads, hd = q.shape
    S, chunk = k_cache.shape[2], cache_chunk
    G = n_heads // n_kv
    int8 = k_scales is not None
    ninf = float("-inf")
    qs = q * scale
    out = torch.empty((B, n_heads, hd), dtype=torch.float32,
                      device=q.device)
    for b in range(B):
        off = int(offs[b])
        if ring is None:
            lo = max(0, off - window) if window is not None else 0
            hi = min(off, S)
            p_abs = torch.arange(S, device=q.device)
            vis = p_abs < off
        else:
            head, size = ring
            lo, hi = 0, off if off < head else head + min(size, off - head)
            p_abs, vis = ring_k_positions(*ring, off, device=q.device,
                                          slots=S)
        if window is not None:
            vis = vis & ((off - p_abs) <= window)
        n_chunks = -(-hi // chunk) - lo // chunk if hi > lo else 0
        rounds = _chunk_walk_pieces(lo, hi, chunk, cluster,
                                   round_chunks or max(n_chunks, 1), tile)
        for jh in range(n_kv):
            heads = jh * G + torch.arange(G, device=q.device)
            qv = qs[b, heads]  # [G, hd] f32
            if int8:
                qq, sq = _absmax_codes(qv, 1e-8)
            s_self = _sum64(qv.double() * k[b, jh].double())
            m_base = torch.full_like(s_self, -1e30)
            m, den = m_base, torch.zeros_like(s_self)
            ctx = torch.zeros_like(qv)
            for ca, cb, pieces in rounds:
                # Scores, then each piece's M and F.
                sc, mx, fx = [], [], []
                for p0, p1 in pieces:
                    kc = k_cache[b, jh, p0:p1].double()
                    if int8:
                        s_ = ((qq.double() @ kc.T).float() * sq
                              * k_scales[b, jh, p0:p1])
                    else:
                        s_ = (qv.to(torch.bfloat16).double() @ kc.T).float()
                    s_ = torch.where(vis[p0:p1], s_, ninf)
                    sc.append(s_)
                    if p1 > p0:
                        first_end = min(p1, (p0 // chunk + 1) * chunk)
                        mx.append(s_.amax(-1))
                        fx.append(s_[:, :first_end - p0].amax(-1))
                    else:
                        mx.append(torch.full_like(s_self, ninf))
                        fx.append(torch.full_like(s_self, ninf))
                # Per piece and chunk: m_c, then e, the f64 denominator,
                # the weights (int8: e x vs and its absmax).
                rec = []  # per piece: {chunk: [m, den, w, ea, (s0, s1)]}
                for i, (p0, p1) in enumerate(pieces):
                    rec.append({})
                    if p1 <= p0:
                        continue
                    run = m_base
                    for mq in mx[:i]:
                        run = torch.maximum(run, mq)
                    c_first, c_last = p0 // chunk, (p1 - 1) // chunk
                    for c in range(c_first, c_last + 1):
                        s0, s1 = max(p0, c * chunk), min(p1, (c + 1) * chunk)
                        seg = sc[i][:, s0 - p0:s1 - p0]
                        run = torch.maximum(run, seg.amax(-1))
                        if c == c_last:
                            for j2 in range(i + 1, len(pieces)):
                                q0, q1 = pieces[j2]
                                if q1 > q0 and q0 < (c + 1) * chunk:
                                    run = torch.maximum(run, fx[j2])
                        e = torch.exp(seg - run[:, None])
                        d_ = e.double().sum(-1)
                        if int8:
                            w_ = torch.where(vis[s0:s1],
                                             e * v_scales[b, jh, s0:s1],
                                             torch.zeros_like(e))
                            ea = w_.abs().amax(-1)
                        else:
                            w_, ea = e.to(torch.bfloat16), None
                        rec[i][c] = [run, d_, w_, ea, (s0, s1)]
                # int8: each chunk's group over its pieces, then the codes;
                # the P.V partials.
                for c in range(ca, cb):
                    owners = [r_[c] for r_ in rec if c in r_]
                    se = None
                    if int8:
                        ea = owners[0][3]
                        for o in owners[1:]:
                            ea = torch.maximum(ea, o[3])
                        se = (torch.clamp(ea, min=1e-30)
                              / torch.full_like(ea, 127.0))
                    for o in owners:
                        s0, s1 = o[4]
                        w_ = o[2]
                        if int8:
                            w_ = torch.clamp(torch.round(w_ / se[:, None]),
                                             -127, 127)
                        o.append(w_.double() @ v_cache[b, jh, s0:s1].double())
                    # The fold: partials in piece order, rounded once.
                    d_, pv = owners[0][1], owners[0][5]
                    for o in owners[1:]:
                        d_, pv = d_ + o[1], pv + o[5]
                    den_c, pv_c = d_.float(), pv.float()
                    if int8:
                        pv_c = pv_c * se[:, None]
                    m_c = owners[0][0]
                    alpha = torch.exp(m - m_c)
                    den = den * alpha + den_c
                    ctx = ctx * alpha[:, None] + pv_c
                    m = m_c
                for mq in mx:
                    m_base = torch.maximum(m_base, mq)
            m_f = torch.maximum(m, s_self)
            alpha = torch.exp(m - m_f)
            e_self = torch.exp(s_self - m_f)
            den = den * alpha + e_self
            ctx = ctx * alpha[:, None] + e_self[:, None] * v[b, jh]
            out[b, heads] = ctx / den[:, None]
    return out.reshape(B, n_heads * hd)


def decode_stack_step_plain(
    x, offset,
    attn_norms, ffn_norms, ada_vecs,
    sqkv, so, s13, s2, cos_p, sin_p,
    k_cache, v_cache,
    wqkv, wo, w13, w2,
    final_norm=None, lm_codes=None, lm_scale=None,
    k_scales=None, v_scales=None,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None, spec: int = 1,
    ring: Optional[tuple[int, int]] = None,
    cache_chunk: Optional[int] = None,
    lm_argmax: bool = False,
):
    """Plain PyTorch version of the kernel, step by step as the JAX
    kernel computes it (its spec branch for ``spec > 1``: one pass, not
    K sequential steps).  Returns (x_out [B, D] f32, k_new, v_new
    [L, B, Hkv, hd] cache dtype[, logits [B, V] f32]).

    Float reductions (sum of squares, scores, softmax sum, P.V, the g32
    group sums, the bf16 dots) run in f64 and round once to f32, as the
    CUDA kernel does: both agree bit for bit whatever order each sums in.
    Mode (h): g32 scale stacks [L, N, K/32] (and an lm scale [V, D/32])
    select the group-32 GEMV.  Mode (g): bf16 stacks (or tuples of bf16
    segments, :func:`fuse_decode_weights_bf16`) and a bf16 lm table, the
    scales None.  ``ring`` (mode (d)): the cache is a head+ring
    buffer, masked per slot by
    :func:`~voxtral_tpu_torch.models.layers.ring_k_positions`.
    ``k_scales`` / ``v_scales`` (mode (e)): int8 caches, integer score
    and P.V dots (exact), k_new / v_new still bf16.  ``cache_chunk``
    (mode (f)): the online softmax over chunks; it reads the offsets'
    min and max on the host, which the kernel does on the device.
    ``lm_argmax`` (mode (i), any weight mode): the fourth output is the
    greedy token [B, 1] int32, the first index of each row's largest
    logit, in place of the logits.
    """
    B, D = x.shape
    L, S = k_cache.shape[0], k_cache.shape[3]
    Bc = _spec_streams(B, k_cache.shape[1], spec)
    _check_cache_mode(k_cache, v_cache, k_scales, v_scales, cache_chunk,
                      spec, S)
    new_dtype = torch.bfloat16 if k_scales is not None else k_cache.dtype
    fmt = _weight_format(wqkv, wo, w13, w2, sqkv, so, s13, s2, lm_codes,
                         lm_scale)
    lm_argmax = _check_lm_argmax(lm_argmax, lm_codes)
    nq, nkv = n_heads * head_dim, n_kv * head_dim
    hidden = _segs(w2)[0].shape[2]
    c, s = cos_p.float(), sin_p.float()
    if c.dim() == 2:  # per-row [B, hd] -> [B, 1, hd] against the heads
        c, s = c[:, None], s[:, None]
    offs = torch.as_tensor(offset, device=x.device).reshape(-1).expand(Bc)
    x = x.float()
    k_new, v_new = [], []
    for l in range(L):
        def lin(h, w, sc):
            return _linear_plain(h, _layer(w, l), None if sc is None
                                 else sc[l], fmt)

        h = _rms(x, attn_norms[l].float(), eps)
        qkv = lin(h, wqkv, sqkv)
        q = qkv[:, :nq].reshape(B, n_heads, head_dim)
        k = qkv[:, nq:nq + nkv].reshape(B, n_kv, head_dim)
        v = qkv[:, nq + nkv:].reshape(B, n_kv, head_dim)
        q = q * c + _rope_swap(q) * s
        k = k * c + _rope_swap(k) * s
        k_new.append(k.to(new_dtype))
        v_new.append(v.to(new_dtype))
        attn = _attention_plain(
            q, k, v, k_cache[l], v_cache[l], offs, window, spec, n_kv,
            head_dim ** -0.5, ring,
            None if k_scales is None else k_scales[l],
            None if v_scales is None else v_scales[l], cache_chunk)
        x = x + lin(attn, wo, so)

        h = _rms(x, ffn_norms[l].float(), eps) * ada_vecs[l].float()
        up = lin(h, w13, s13)
        gate, upv = up[:, :hidden], up[:, hidden:]
        hmid = gate * (1.0 / (1.0 + torch.exp(-gate))) * upv
        x = x + lin(hmid, w2, s2)
    out = (x, torch.stack(k_new), torch.stack(v_new))
    if lm_codes is None:
        return out
    h = _rms(x, final_norm.float(), eps)
    logits = _linear_plain(h, lm_codes, lm_scale, fmt)
    if lm_argmax:
        return (*out, lm_token_plain(logits))
    return (*out, logits)


def lm_token_plain(logits: torch.Tensor) -> torch.Tensor:
    """Mode (i)'s fold, plainly: the first index of each row's largest
    logit (``torch.argmax``, as JAX's running (max, first index) over the
    vocab tiles) -> [B, 1] int32."""
    return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)


def _check_lm_argmax(lm_argmax: bool, lm_codes) -> bool:
    """Mode (i) applies with the lm fold only (JAX drops the flag without
    one, ``decode_step_pallas.py:1479``), over a w8, g32 or bf16 table."""
    return bool(lm_argmax and lm_codes is not None)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_stack_step: {msg}")


# The attention blocks' shape (csrc/attn_step.cuh): 256 threads, and a
# block may hold 227 KB of dynamic shared memory on the H100.
ATTN_THREADS = 256
SMEM_LIMIT = 227 * 1024
# Vocab rows per block of the lm fold of mode (i) and K6
# (csrc/lm_argmax.cuh: kLmTile); the fold's partials hold one (max,
# index) pair per tile and row.
LM_TILE = 32


# K1's weight stream (csrc/k1_stream.cuh): a block of STREAM_PARTS warps
# splits K into parts, each warp streaming its part of a group of output
# rows in chunks of kc elements through a ring of shared-memory stages.
STREAM_PARTS = 4
STREAM_MAX_M = 64            # activation rows of one pass over the weights
STREAM_MAX_STAGES = 4
STREAM_BLOCK_SMEM = 232448   # the most shared memory a block may take
STREAM_SM_SMEM = 233472      # an SM's, 1 KB of it held back per block
# Per weight format: element bytes, output rows a group, activation rows
# an mma tile, k elements a step (kc's multiple; g32: a row's scales of a
# chunk in one 16-byte copy), bytes of a partial sum, and the most bytes
# of one weight row a chunk holds.
STREAM_FMT = {"w8": (1, 8, 16, 64, 4, 1024), "bf16": (2, 16, 8, 32, 8, 512),
              "g32": (1, 16, 8, 256, 8, 256)}
STREAM_RING_ROWS = 8         # bf16 / g32 activation rows a slot stages
STREAM_G32_PAD = 32          # bytes after each g32 weight row of a slot
# The fewest rows a step's linear takes the stream with, per format: below
# them the GEMVs of w8_common.cuh / bf16_gemv.cuh and lm_argmax.cuh's
# fold measured faster on the H100 (benches/torch_k1_times.py --plans,
# benches/torch_tp_times.py --plans for K6's g32 fold).
STREAM_MIN_ROWS = {"w8": 33, "bf16": 2, "g32": 5}


class StreamPlan(NamedTuple):
    """One linear's launch: chunk kc (elements), ring stages, persistent
    grid, a block's shared memory and the blocks an SM holds."""
    kc: int
    stages: int
    grid: int
    smem: int
    blocks_per_sm: int


def stream_chunk(fmt: str, k: int) -> int:
    """The chunk kc of a K part, or 0 where the stream does not take K:
    the fewest chunks of at most the format's chunk bytes that split the
    part into whole steps.  It depends on the format and K alone, so a
    row's sum runs in the same order whatever the row count."""
    esize, _, _, align, _, most = STREAM_FMT[fmt]
    if k % (STREAM_PARTS * align):
        return 0
    part = k // STREAM_PARTS
    for n in range(-(-part * esize // most), part // align + 1):
        if part % n == 0 and (part // n) % align == 0:
            return part // n
    return 0


def stream_smem(fmt: str, mt: int, kc: int, stages: int) -> int:
    """A block's shared memory (csrc/k1_stream.cuh::StreamLayout): the
    warps' rings (weight rows, then up to STREAM_RING_ROWS bf16 or g32
    activation rows, g32's rows padded by STREAM_G32_PAD, then g32's f16
    group scales), two buffers of partial sums, the fold's values."""
    esize, rows, mrows, _, vsize, _ = STREAM_FMT[fmt]
    mp = mt * mrows
    g32 = fmt == "g32"
    staged = mt * 8 if fmt != "w8" and mt * 8 <= STREAM_RING_ROWS else 0
    stage = ((rows + staged) * (kc * esize + (STREAM_G32_PAD if g32 else 0))
             + (rows * kc // 16 if g32 else 0))
    stage = -(-stage // 128) * 128
    return (STREAM_PARTS * stages * stage + 2 * STREAM_PARTS * rows * mp
            * vsize + rows * mp * 4)


@functools.lru_cache(maxsize=None)
def stream_plan(fmt: str, m: int, n: int, k: int,
                sms: int) -> Optional[StreamPlan]:
    """The weight stream's launch of one [n, k] linear over m rows on a
    card of ``sms`` SMs, or None where the earlier GEMVs of
    w8_common.cuh / bf16_gemv.cuh run it: a k the stream does not take;
    fewer rows than STREAM_MIN_ROWS: one bf16 row (bf16_row_dots: one
    warp per output row, no padding to the 8-row tile), g32 up to 4 rows
    (the dp4a GEMV, its one-row form loading its weights before the wait)
    and w8 up to 32 rows, where the dp4a and mma GEMVs measured faster on
    the H100
    (benches/torch_k1_times.py).  As many blocks an SM as the kernel's
    registers allow (4 up to 4 row tiles, else 2) while rings of at
    least two stages fit (g32: more warps an SM, not deeper rings,
    measured faster); at most STREAM_MAX_STAGES stages; the grid
    holds every group of rows or fills the card."""
    if fmt not in STREAM_FMT or m < STREAM_MIN_ROWS[fmt] or n < 1:
        return None
    kc = stream_chunk(fmt, k)
    if not kc:
        return None
    rows, mrows = STREAM_FMT[fmt][1], STREAM_FMT[fmt][2]
    mt = -(-min(m, STREAM_MAX_M) // mrows)
    fixed = stream_smem(fmt, mt, kc, 0)
    per_stage = stream_smem(fmt, mt, kc, 1) - fixed
    most = 4 if mt <= 4 else 2  # the kernel's register budget
    for bps in range(most, 0, -1):
        budget = min(STREAM_SM_SMEM // bps - 1024, STREAM_BLOCK_SMEM)
        stages = min(STREAM_MAX_STAGES, (budget - fixed) // per_stage)
        if stages >= 2 or (bps == 1 and stages >= 1):
            grid = min(-(-n // rows), sms * bps)
            return StreamPlan(kc, stages, grid,
                              stream_smem(fmt, mt, kc, stages), bps)
    return None


# Whether K1 launches the kernels of a one-row step, or of a step the
# weight stream takes (STREAM_MIN_ROWS), as programmatic dependent
# launches (True); other steps, and every step with False
# (benches/torch_k1_times.py --pdl 0), go in plain stream order.
K1_PDL = True


def k1_stream_plans(fmt: str, m: int, dim: int, nq: int, nqkv: int,
                    hidden: int, vocab: int, sms: int) -> list:
    """The step's plans (kc, stages, grid) of qkv, wo, w13, w2 and the lm
    table, flat; (0, 0, 0) for a linear the stream does not take or the
    lm table when there is none."""
    out = []
    for n, k in ((nqkv, dim), (dim, nq), (2 * hidden, dim), (dim, hidden),
                 (vocab, dim)):
        p = stream_plan(fmt, m, n, k, sms) if n else None
        out += [p.kc, p.stages, p.grid] if p else [0, 0, 0]
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _card_index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def _plan_array(plans: list):
    return (ctypes.c_int * len(plans))(*plans)


def kernel_attn_plan(streams: int, n_heads: int, n_kv: int, spec: int,
                     head_dim: int, span: int, kv_int8: bool) -> tuple:
    """(cluster, vectors, groups, piece, bytes) of the cluster walk at a
    geometry, from the built library (``vx_attn_plan``,
    attn_step.cuh::attn_plan): blocks a cluster, query vectors a
    cluster, clusters per (stream, kv head), score slots a block and a
    block's shared memory; (0, 0, 0, 0, 0) when nothing fits."""
    out = (ctypes.c_longlong * 5)()
    fn = kernel_fn("vx_attn_plan", [_I] * 7 + [ctypes.c_void_p])
    fn(streams, n_heads, n_kv, spec, head_dim, span, int(kv_int8),
       ctypes.cast(out, ctypes.c_void_p))
    return tuple(int(x) for x in out)


def kernel_chunk_plan(streams: int, n_heads: int, n_kv: int, head_dim: int,
                      span: int, cache_chunk: int, kv_int8: bool) -> tuple:
    """(cluster, vectors, groups, piece, round chunks, records, bytes) of
    mode (f)'s chunked walk at a geometry, from the built library
    (``vx_attn_chunk_plan``, attn_step.cuh::chunk_plan): blocks a
    cluster, query vectors a cluster, clusters per (stream, kv head),
    score slots a block, chunks a round, chunk records a block and a
    block's shared memory; ``span`` the most slots a row sees
    (:func:`attn_span` without the chunk); cluster 0 when nothing
    fits."""
    out = (ctypes.c_longlong * 7)()
    fn = kernel_fn("vx_attn_chunk_plan", [_I] * 7 + [ctypes.c_void_p])
    code = fn(streams, n_heads, n_kv, head_dim, span, cache_chunk,
              int(kv_int8), ctypes.cast(out, ctypes.c_void_p))
    if code:
        raise ValueError(f"no chunk plan for cache_chunk={cache_chunk}, "
                         f"heads {n_heads} / {n_kv}")
    return tuple(int(x) for x in out)


def attn_span(S: int, window: Optional[int] = None,
              ring: Optional[tuple[int, int]] = None,
              cache_chunk: Optional[int] = None) -> int:
    """The most cache slots one row sees at once: the chunk in mode (f),
    the window on a bounded cache, else all S."""
    if cache_chunk:
        return cache_chunk
    return S if ring is not None or window is None or window >= S else window


def attn_smem_bytes(S: int, head_dim: int, window: Optional[int] = None,
                    spec: int = 1,
                    ring: Optional[tuple[int, int]] = None,
                    cache_chunk: Optional[int] = None,
                    kv_int8: bool = False) -> int:
    """Shared memory :func:`check_geometry` holds an attention block to:
    a block per (row, query head) with the per-warp P.V partials (f64),
    q, bf16(q) (or its int8 codes), k, v, the spec fresh scores (and
    fresh v scales in the int8 / chunked walk) and one score per slot of
    the span (mode (f): the chunk).  The cluster walks hold the span's
    scores over up to 16 blocks, sized by the library's plans
    (:func:`kernel_attn_plan`; mode (f) :func:`kernel_chunk_plan`, in
    rounds of chunks where a span is longer than a cluster holds), and
    fit wherever this does."""
    span = attn_span(S, window, ring, cache_chunk)
    fresh = (2 if cache_chunk or kv_int8 else 1) * spec
    return 8 * (ATTN_THREADS // 32) * head_dim + 4 * (4 * head_dim + fresh
                                                      + span)


def _check_chunk(S: int, cache_chunk: Optional[int], spec: int) -> None:
    """Mode (f)'s guards (``decode_step_pallas.py:1404-1405``,
    ``:1449-1451``): no spec, and the chunk divides S."""
    if cache_chunk is None:
        return
    if spec > 1:
        raise ValueError("speculative decode + cache_chunk unsupported")
    if cache_chunk < 1 or S % cache_chunk:
        raise ValueError(
            f"cache_chunk {cache_chunk} must divide S {S} (pad the cache)")


def check_geometry(S: int, head_dim: int, window: Optional[int] = None,
                   spec: int = 1,
                   ring: Optional[tuple[int, int]] = None,
                   cache_chunk: Optional[int] = None,
                   kv_int8: bool = False) -> None:
    """ValueError naming the cause when the kernel cannot take a cache of
    S slots: the span's scores (S or the window's floats; ``cache_chunk``
    floats in mode (f), whatever S) in one block's shared memory,
    :func:`attn_smem_bytes`.  The cluster walk of modes (a)-(e) could
    take longer spans; admitting them moves rungs of ``oneshot_plan`` and
    ``_fused_plan``, which waits for its own change (ROADMAP)."""
    _check_chunk(S, cache_chunk, spec)
    need = attn_smem_bytes(S, head_dim, window, spec, ring, cache_chunk,
                           kv_int8)
    _require(need <= SMEM_LIMIT,
             f"a cache of {S} slots (window {window}, ring {ring}, "
             f"spec={spec}, cache_chunk={cache_chunk}) needs {need} bytes "
             f"of shared memory per attention block, above the "
             f"{SMEM_LIMIT} a block may hold")
    if ring is not None:
        head, size = ring
        _require(head >= 0 and size >= 1 and head + size <= S,
                 f"ring {ring} does not fit a cache of {S} slots")


def _check_cache_mode(k_cache, v_cache, k_scales, v_scales, cache_chunk,
                      spec: int, S: int) -> None:
    """The JAX wrapper's guards for modes (f) and (e)
    (``decode_step_pallas.py:1480-1482`` for the latter)."""
    _check_chunk(S, cache_chunk, spec)
    int8 = k_cache.dtype == torch.int8
    if int8 != (v_cache.dtype == torch.int8):
        raise ValueError("k_cache and v_cache must share a dtype")
    if int8 and (k_scales is None or v_scales is None):
        raise ValueError("int8 KV cache needs k_scales/v_scales")
    if not int8 and (k_scales is not None or v_scales is not None):
        raise ValueError("k_scales/v_scales need int8 caches")


def _weight_format(wqkv, wo, w13, w2, sqkv, so, s13, s2, lm_codes,
                   lm_scale) -> str:
    """"w8", "g32" (mode (h)) or "bf16" (mode (g)) from the stacks;
    ValueError as the JAX wrapper's guards (``decode_step_pallas.py:
    1405-1480``) for what a mode cannot take."""
    segs = [_segs(w) for w in (wqkv, wo, w13, w2)]
    if segs[0][0].dtype == torch.bfloat16:
        if any(t.dtype != torch.bfloat16 for sg in segs for t in sg):
            raise ValueError("bf16 weight mode needs bf16 stacks")
        if (len(segs[0]) > 3 or len(segs[1]) != 1 or len(segs[2]) > 2
                or len(segs[3]) != 1):
            raise ValueError("bf16 weight mode streams qkv in up to three "
                             "segments, w13 in up to two, wo and w2 whole")
        if lm_codes is not None and lm_codes.dtype == torch.int8:
            raise ValueError("lm_codes dtype must match the weight mode")
        return "bf16"
    if any(len(sg) > 1 for sg in segs):
        raise ValueError("segmented stacks need the bf16 weight mode")
    if lm_codes is not None and lm_codes.dtype != torch.int8:
        raise ValueError("lm_codes dtype must match the weight mode")
    return "g32" if _g32_mode(wqkv, wo, w13, w2, sqkv, so, s13, s2,
                              lm_codes, lm_scale) else "w8"


def _g32_mode(wqkv, wo, w13, w2, sqkv, so, s13, s2, lm_codes,
              lm_scale) -> bool:
    """True for mode (h): g32 scale stacks [L, N, K/32].  ValueError as
    the JAX wrapper's guards (``decode_step_pallas.py:1415-1428``,
    ``:1464-1468``) for what g32 mode cannot take."""
    wg = sqkv is not None and sqkv.dim() == 3
    if not wg:
        return False
    if any(w.dtype != torch.int8 for w in (wqkv, wo, w13, w2)):
        raise ValueError("g32 stack weights must be int8 codes")
    for w, s in ((wqkv, sqkv), (wo, so), (w13, s13), (w2, s2)):
        if s is None or s.dim() != 3 or w.shape[2] % 32 or tuple(
                s.shape) != (*w.shape[:2], w.shape[2] // 32):
            raise ValueError("g32 mode needs [L, N, K/32] group-scale "
                             "stacks (fuse_decode_weights_q4g)")
    if lm_codes is not None:
        if lm_codes.dtype != torch.int8:
            raise ValueError("lm_codes dtype must match the weight mode")
        if (lm_codes.dim() != 2 or lm_scale is None or lm_scale.dim() != 2
                or tuple(lm_scale.shape) != (lm_codes.shape[0],
                                             lm_codes.shape[1] // 32)):
            raise ValueError("g32 lm fold needs codes [V, D] + scales "
                             "[V, D/32] (fuse_decode_weights_q4g)")
    return True


def decode_stack_step(
    x, offset,
    attn_norms, ffn_norms, ada_vecs,
    sqkv, so, s13, s2, cos_p, sin_p,
    k_cache, v_cache,
    wqkv, wo, w13, w2,
    final_norm=None, lm_codes=None, lm_scale=None,
    k_scales=None, v_scales=None,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None, spec: int = 1,
    ring: Optional[tuple[int, int]] = None,
    cache_chunk: Optional[int] = None,
    lm_argmax: bool = False,
):
    """All decoder layers of one decode step (+ lm fold).

    x [B, D] f32, B = Bc streams x ``spec`` rows ordered (stream b, draft
    slot j); ``offset`` = cache slots already written per stream: an int
    (every stream) or an int32 tensor [Bc] on x's device; cos_p / sin_p
    [hd] (every row) or per row [B, hd] (row (b, j) at offs[b] + j);
    caches head-major [L, Bc, Hkv, S, hd] bf16 (read at slots < offs[b]
    only); fused w8 stacks from :func:`fuse_decode_weights`; ``window`` =
    sliding window (None: no lower bound).  ``spec=K > 1`` verifies K
    drafted tokens per stream: row j also attends the fresh K/V of rows
    i < j of its stream.  g32 stacks from :func:`fuse_decode_weights_q4g`
    select mode (h); bf16 stacks (``wqkv`` and ``w13`` may be tuples of
    segments) with a bf16 lm table and no scales, from
    :func:`fuse_decode_weights_bf16`, mode (g).  ``ring=(head, size)``
    (mode (d)): the caches are
    head+ring buffers and ``offset`` the absolute position (any
    non-negative int or tensor; slots by ``layers.ring_k_positions``).
    int8 caches with ``k_scales`` / ``v_scales`` [L, Bc, Hkv, S] f32
    (mode (e)): the caller quantizes k_new / v_new (bf16) with
    :func:`quantize_kv` and appends codes and scales.
    ``cache_chunk=Sc`` (mode (f); Sc divides S, spec = 1): the attention
    walks the cache in chunks of Sc slots, so S is not bounded by shared
    memory.  ``lm_argmax=True`` (mode (i), with the lm fold, over any
    table): the greedy token [B, 1] int32 in place of the logits, which
    are never written (``csrc/lm_argmax.cuh``).
    Returns (x_out, k_new, v_new[, logits or token]) like
    :func:`decode_stack_step_plain`, k_new / v_new [L, B, Hkv, hd]; the
    caller appends them.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    or raise.  Each launch adds one to ``decode_stack_step.launches``, a
    mode (i) launch also to ``decode_stack_step.argmax_launches`` (and,
    over a g32 or a bf16 table, to ``decode_stack_step.argmax_g32_launches``
    or ``decode_stack_step.argmax_bf16_launches``); a g32 step whose
    linears take the weight stream (``csrc/k1_stream.cuh``) also to
    ``decode_stack_step.g32_stream_launches``.
    """
    args = (x, offset, attn_norms, ffn_norms, ada_vecs, sqkv, so, s13, s2,
            cos_p, sin_p, k_cache, v_cache, wqkv, wo, w13, w2,
            final_norm, lm_codes, lm_scale, k_scales, v_scales)
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps,
              window=window, spec=spec, ring=ring, cache_chunk=cache_chunk,
              lm_argmax=lm_argmax)
    dev = x.device
    if dev.type == "cpu":
        return decode_stack_step_plain(*args, **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"decode_stack_step: unsupported device {dev}")

    B, D = x.shape
    L, Bc, Hkv, S, hd = k_cache.shape
    Bc = _spec_streams(B, Bc, spec)
    fmt = _weight_format(wqkv, wo, w13, w2, sqkv, so, s13, s2, lm_codes,
                         lm_scale)
    g32, bf16 = fmt == "g32", fmt == "bf16"
    lm_argmax = _check_lm_argmax(lm_argmax, lm_codes)
    nq, nkvd = n_heads * head_dim, n_kv * head_dim
    F = _segs(w2)[0].shape[2]
    offs = None
    if isinstance(offset, torch.Tensor):
        _require(offset.dtype == torch.int32 and offset.shape == (Bc,)
                 and offset.device == dev and offset.is_contiguous(),
                 f"an offset tensor must be contiguous int32 ({Bc},) on "
                 f"{dev}, got {offset.dtype} {tuple(offset.shape)} on "
                 f"{offset.device}")
        offs, offset = offset, 0
    hi = S if ring is None else 2 ** 31 - 1
    _require(isinstance(offset, int) and 0 <= offset <= hi,
             f"offset must be an int in [0, {hi}] or a tensor, got "
             f"{offset!r}")
    _check_cache_mode(k_cache, v_cache, k_scales, v_scales, cache_chunk,
                      spec, S)
    kv_int8 = k_scales is not None
    check_geometry(S, head_dim, window, spec, ring, cache_chunk, kv_int8)
    _require(not kv_int8 or head_dim % 4 == 0,
             "the int8 cache needs head_dim % 4 == 0")
    _require(Hkv == n_kv and hd == head_dim,
             f"cache {tuple(k_cache.shape)} does not match n_kv={n_kv}, "
             f"head_dim={head_dim}")
    _require(head_dim % 2 == 0 and head_dim <= 256 and n_heads % n_kv == 0,
             "head_dim must be even and <= 256, n_kv must divide n_heads")
    rope_shape = (head_dim,) if cos_p.dim() == 1 else (B, head_dim)
    cache_dtype = torch.int8 if kv_int8 else torch.bfloat16
    # Row scales [L, N] f32 (w8) or group scales [L, N, K/32] f16 (g32);
    # mode (g) has none.
    sdt = torch.float16 if g32 else torch.float32
    wdt = torch.bfloat16 if bf16 else torch.int8

    def sshape(n, k):
        return (L, n, k // 32) if g32 else (L, n)

    expect = {
        "x": (x, torch.float32, (B, D)),
        "attn_norms": (attn_norms, torch.float32, (L, D)),
        "ffn_norms": (ffn_norms, torch.float32, (L, D)),
        "ada_vecs": (ada_vecs, torch.float32, (L, D)),
        "cos_p": (cos_p, torch.float32, rope_shape),
        "sin_p": (sin_p, torch.float32, rope_shape),
        "k_cache": (k_cache, cache_dtype, (L, Bc, n_kv, S, head_dim)),
        "v_cache": (v_cache, cache_dtype, (L, Bc, n_kv, S, head_dim)),
        "wo": (_segs(wo)[0], wdt, (L, D, nq)),
        "w2": (_segs(w2)[0], wdt, (L, D, F)),
    }
    qkv_segs, w13_segs = _segs(wqkv), _segs(w13)
    if bf16:
        # The segments' rows add up to the stack's; two w13 segments are
        # w1 and w3, F rows each.
        for name, sg, n in (("wqkv", qkv_segs, nq + 2 * nkvd),
                            ("w13", w13_segs, 2 * F)):
            rows = [t.shape[1] if t.dim() == 3 else -1 for t in sg]
            _require(sum(rows) == n and all(r > 0 for r in rows)
                     and (name == "wqkv" or len(sg) == 1 or rows[0] == F),
                     f"{name} segments of {rows} rows do not make the "
                     f"{n} rows of the stack")
            for i, t in enumerate(sg):
                expect[f"{name}[{i}]"] = (t, wdt, (L, t.shape[1], D))
    else:
        expect.update({
            "sqkv": (sqkv, sdt, sshape(nq + 2 * nkvd, D)),
            "so": (so, sdt, sshape(D, nq)),
            "s13": (s13, sdt, sshape(2 * F, D)),
            "s2": (s2, sdt, sshape(D, F)),
            "wqkv": (wqkv, wdt, (L, nq + 2 * nkvd, D)),
            "w13": (w13, wdt, (L, 2 * F, D)),
        })
    if kv_int8:
        expect["k_scales"] = (k_scales, torch.float32, (L, Bc, n_kv, S))
        expect["v_scales"] = (v_scales, torch.float32, (L, Bc, n_kv, S))
    V = 0
    if lm_codes is not None:
        V = lm_codes.shape[0]
        expect["final_norm"] = (final_norm, torch.float32, (D,))
        expect["lm_codes"] = (lm_codes, wdt, (V, D))
        if not bf16:  # a dense table carries no scale
            expect["lm_scale"] = (lm_scale, sdt,
                                  (V, D // 32) if g32 else (V,))
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
    logits = torch.empty((B, V), **f32) if V and not lm_argmax else None
    token = tmax = tidx = None
    if lm_argmax:  # mode (i): the token and the fold's per-tile partials
        token = torch.empty((B, 1), dtype=torch.int32, device=dev)
        tiles = -(-V // 8)  # the stream's groups of 8 or 16 rows, LM_TILE
        tmax = torch.empty((B, tiles), **f32)
        tidx = torch.empty((B, tiles), dtype=torch.int32, device=dev)
    # The GEMVs' input rows: int8 codes, or bf16 in mode (g).
    xq_buf = torch.empty((B, max(D, nq, F)), dtype=wdt, device=dev)
    sx_buf = torch.empty((B,), **f32)
    qkv_buf = torch.empty((B, nq + 2 * nkvd), **f32)
    attn_buf = torch.empty((B, nq), **f32)
    up_buf = torch.empty((B, 2 * F), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def seg(sg, i):
        return sg[i] if i < len(sg) else None

    ring_head, ring_size = ring if ring is not None else (0, 0)
    plans = k1_stream_plans(fmt, B, D, nq, nq + 2 * nkvd, F, V,
                            _sm_count(_card_index(dev)))
    # Early launches where they measured faster: one row, or a step the
    # weight stream takes.
    streamed = any(plans)
    plans = _plan_array(plans + [int(K1_PDL and (B == 1 or streamed))])
    with torch.cuda.device(dev):
        fn = kernel_fn("vx_decode_stack_step", [_P] * 37 + [_I] * 20
                       + [_F, _F, _P, _P])
        stream = torch.cuda.current_stream(dev).cuda_stream
        qkv_b = seg(qkv_segs, 1)
        code = fn(
            ptr(x), ptr(x_out), ptr(attn_norms), ptr(ffn_norms), ptr(ada_vecs),
            ptr(None if bf16 else sqkv), ptr(None if bf16 else so),
            ptr(None if bf16 else s13), ptr(None if bf16 else s2), ptr(cos_p),
            ptr(sin_p), ptr(k_cache), ptr(v_cache), ptr(qkv_segs[0]),
            ptr(_segs(wo)[0]), ptr(w13_segs[0]), ptr(_segs(w2)[0]),
            ptr(final_norm), ptr(lm_codes), ptr(None if bf16 else lm_scale),
            ptr(k_new), ptr(v_new), ptr(logits),
            ptr(xq_buf), ptr(sx_buf), ptr(qkv_buf), ptr(attn_buf), ptr(up_buf),
            ptr(offs), ptr(k_scales), ptr(v_scales), ptr(qkv_b),
            ptr(seg(qkv_segs, 2)), ptr(seg(w13_segs, 1)), ptr(token),
            ptr(tmax), ptr(tidx), B, D, L, S, n_heads,
            n_kv, head_dim, F, V, offset, spec,
            0 if cos_p.dim() == 1 else head_dim,
            -1 if window is None else int(window),
            {"w8": 0, "g32": 1, "bf16": 2}[fmt], qkv_segs[0].shape[1],
            0 if qkv_b is None else qkv_b.shape[1], ring_head, ring_size,
            int(cache_chunk or 0), int(lm_argmax), eps, head_dim ** -0.5,
            plans, stream)
    check(code, "decode_stack_step")
    decode_stack_step.launches += 1
    decode_stack_step.g32_stream_launches += g32 and streamed
    out = (x_out, k_new, v_new)
    if lm_argmax:
        decode_stack_step.argmax_launches += 1
        decode_stack_step.argmax_g32_launches += g32
        decode_stack_step.argmax_bf16_launches += bf16
        return (*out, token)
    return out if logits is None else (*out, logits)


decode_stack_step.launches = 0
decode_stack_step.argmax_launches = 0
decode_stack_step.argmax_g32_launches = 0
decode_stack_step.argmax_bf16_launches = 0
decode_stack_step.g32_stream_launches = 0


def k1_linear_plain(x, w, scale=None, sx=None, resid=None,
                    lm_argmax: bool = False) -> torch.Tensor:
    """Plain version of :func:`k1_linear`: the step's linear in its
    weight format (w8: :func:`w8_matmul_plain`; g32:
    :func:`g32_matmul_plain`; bf16: :func:`bf16_matmul_plain` over the
    segments) plus ``resid``, or the first index of each row's largest
    value [M, 1] int32."""
    if x.dtype == torch.bfloat16:
        y = torch.cat([bf16_matmul_plain(x, t) for t in _segs(w)], dim=1)
    elif scale.dtype == torch.float16:
        y = g32_matmul_plain(x, sx.reshape(-1, 1), w, scale)
    else:
        y = w8_matmul_plain(x, sx, w, scale)
    if lm_argmax:
        return lm_token_plain(y)
    return y if resid is None else resid + y


def k1_linear(x, w, scale=None, sx=None, resid=None,
              lm_argmax: bool = False) -> torch.Tensor:
    """One linear of K1's weight stream alone, launched as the step
    launches it (``vx_k1_linear``: the stream of ``csrc/k1_stream.cuh``
    where :func:`stream_plan` takes the shape, else the earlier GEMV or
    fold).  x [M, K] int8 with row scales sx [M] f32 against w8 codes
    w [N, K] int8 (scale [N] f32) or g32 codes (scale [N, K/32] f16), or
    x [M, K] bf16 against bf16 weights w [N, K] (or a tuple of segments,
    [n_i, K] each).  -> [M, N] f32 (+ resid [M, N]) or, ``lm_argmax``,
    the token [M, 1] int32.  CPU tensors take :func:`k1_linear_plain`;
    each launch adds one to ``k1_linear.launches``."""
    if x.device.type == "cpu":
        return k1_linear_plain(x, w, scale, sx, resid, lm_argmax)
    segs = _segs(w)
    bf16 = x.dtype == torch.bfloat16
    fmt = "bf16" if bf16 else ("g32" if scale.dtype == torch.float16
                               else "w8")
    M, K = x.shape
    N = sum(t.shape[0] for t in segs)
    dev = x.device
    for t in (x, sx, scale, resid, *segs):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("k1_linear: contiguous tensors on one device")
    if len(segs) > 3 or (not bf16 and len(segs) > 1):
        raise ValueError("k1_linear: bf16 takes up to three segments, "
                         "w8 / g32 one")
    p = stream_plan(fmt, M, N, K, _sm_count(_card_index(dev)))
    f32 = dict(dtype=torch.float32, device=dev)
    out = token = tmax = tidx = None
    if lm_argmax:
        token = torch.empty((M, 1), dtype=torch.int32, device=dev)
        tmax = torch.empty((M, -(-N // 8)), **f32)
        tidx = torch.empty((M, -(-N // 8)), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((M, N), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        fn = kernel_fn("vx_k1_linear", [_I] + [_P] * 13 + [_I] * 3
                       + [_P, _P])
        code = fn({"w8": 0, "g32": 1, "bf16": 2}[fmt], ptr(x), ptr(sx),
                  ptr(segs[0]), ptr(segs[1]) if len(segs) > 1 else None,
                  ptr(segs[2]) if len(segs) > 2 else None,
                  segs[0].shape[0], segs[1].shape[0] if len(segs) > 1 else 0,
                  ptr(scale), ptr(resid), ptr(out), ptr(tmax), ptr(tidx),
                  ptr(token), M, N, K,
                  _plan_array([p.kc, p.stages, p.grid] if p else [0, 0, 0]),
                  torch.cuda.current_stream(dev).cuda_stream)
    check(code, "k1_linear")
    k1_linear.launches += 1
    return token if lm_argmax else out


k1_linear.launches = 0


def attention_block_plain(qkv, cos_p, sin_p, k_cache, v_cache, offset, *,
                          n_heads: int, n_kv: int, head_dim: int,
                          window: Optional[int] = None, spec: int = 1,
                          ring: Optional[tuple[int, int]] = None,
                          k_scales=None, v_scales=None,
                          cache_chunk: Optional[int] = None):
    """One layer's attention of the plain step (its RoPE, then
    :func:`_attention_plain`): qkv [B, nq + 2 nkv] f32 un-roped, cos_p /
    sin_p [hd] or [B, hd], caches [Bc, Hkv, S, hd] of one layer (int8 with
    ``k_scales`` / ``v_scales`` [Bc, Hkv, S]).  -> (attn [B, nq] f32,
    k_new, v_new [B, Hkv, hd] bf16)."""
    B = qkv.shape[0]
    nq, nkv = n_heads * head_dim, n_kv * head_dim
    c, s = cos_p.float(), sin_p.float()
    if c.dim() == 2:
        c, s = c[:, None], s[:, None]
    q = qkv[:, :nq].reshape(B, n_heads, head_dim)
    k = qkv[:, nq:nq + nkv].reshape(B, n_kv, head_dim)
    v = qkv[:, nq + nkv:].reshape(B, n_kv, head_dim)
    q = q * c + _rope_swap(q) * s
    k = k * c + _rope_swap(k) * s
    Bc = B // spec
    offs = torch.as_tensor(offset, device=qkv.device).reshape(-1).expand(Bc)
    attn = _attention_plain(q, k, v, k_cache, v_cache, offs, window, spec,
                            n_kv, head_dim ** -0.5, ring, k_scales, v_scales,
                            cache_chunk)
    return attn, k.to(torch.bfloat16), v.to(torch.bfloat16)


def attention_block(qkv, cos_p, sin_p, k_cache, v_cache, offset, *,
                    n_heads: int, n_kv: int, head_dim: int,
                    window: Optional[int] = None, spec: int = 1,
                    ring: Optional[tuple[int, int]] = None,
                    k_scales=None, v_scales=None,
                    cache_chunk: Optional[int] = None):
    """The attention of one layer alone, launched as K1 and K4 launch it
    inside their steps (``csrc/attn_step.cuh``: the cluster walk, in mode
    (f) over chunks); arguments and result as
    :func:`attention_block_plain`, ``offset`` an int or an int32 device
    tensor [Bc].  Not on the main path: the card tests and
    ``chip_smoke.py`` check and time the block with it.  CPU tensors
    take the plain version; each launch adds one to
    ``attention_block.launches``."""
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, window=window,
              spec=spec, ring=ring, k_scales=k_scales, v_scales=v_scales,
              cache_chunk=cache_chunk)
    dev = qkv.device
    if dev.type == "cpu":
        return attention_block_plain(qkv, cos_p, sin_p, k_cache, v_cache,
                                     offset, **kw)
    B = qkv.shape[0]
    Bc, Hkv, S, hd = k_cache.shape
    _spec_streams(B, Bc, spec)
    _check_cache_mode(k_cache, v_cache, k_scales, v_scales, cache_chunk,
                      spec, S)
    kv_int8 = k_scales is not None
    check_geometry(S, head_dim, window, spec, ring, cache_chunk, kv_int8)
    _require(Hkv == n_kv and hd == head_dim
             and qkv.shape[1] == (n_heads + 2 * n_kv) * head_dim,
             "qkv / cache shapes do not match the heads")
    offs = None
    if isinstance(offset, torch.Tensor):
        _require(offset.dtype == torch.int32 and offset.shape == (Bc,),
                 "an offset tensor must be int32 (Bc,)")
        offs, offset = offset, 0
    for t in (qkv, cos_p, sin_p, k_cache, v_cache, k_scales, v_scales, offs):
        _require(t is None or (t.device == dev and t.is_contiguous()),
                 f"every tensor must be contiguous on {dev}")
    attn = torch.empty((B, n_heads * head_dim), dtype=torch.float32,
                       device=dev)
    k_new = torch.empty((B, n_kv, head_dim), dtype=torch.bfloat16,
                        device=dev)
    v_new = torch.empty_like(k_new)
    ring_head, ring_size = ring if ring is not None else (0, 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        fn = kernel_fn("vx_attn_block", [_P] * 11 + [_I] * 12 + [_F, _P])
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(ptr(qkv), ptr(cos_p), ptr(sin_p), ptr(k_cache),
                  ptr(v_cache), ptr(k_scales), ptr(v_scales), ptr(k_new),
                  ptr(v_new), ptr(attn), ptr(offs), B, S, n_heads, n_kv,
                  head_dim, offset, spec,
                  0 if cos_p.dim() == 1 else head_dim,
                  -1 if window is None else int(window), ring_head,
                  ring_size, int(cache_chunk or 0), head_dim ** -0.5, stream)
    check(code, "attention_block")
    attention_block.launches += 1
    return attn, k_new, v_new


attention_block.launches = 0


# ---------------------------------------------------------------------------
# K7: one decoder layer over the position-major cache
# ---------------------------------------------------------------------------


def _layer_attention_plain(q, k, v, k_cache, v_cache, offset: int, window,
                           n_kv: int, scale: float) -> torch.Tensor:
    """K7's attention (JAX ``_make_kernel``): q [B, H, hd], k / v [B, Hkv,
    hd] RoPE'd f32; caches position-major [B, S, Hkv, hd] bf16 (slots <
    ``offset`` within the window visible).  The scaled q stays f32 and
    the softmax weights f32 (K1 rounds both to bf16).  -> [B, H * hd]."""
    B, n_heads, hd = q.shape
    S = k_cache.shape[1]
    qg = (q * scale).reshape(B, n_kv, n_heads // n_kv, hd)
    kc = k_cache.permute(0, 2, 1, 3).double()  # [B, Hkv, S, hd]
    vc = v_cache.permute(0, 2, 1, 3).double()
    pos = torch.arange(S, device=q.device)
    valid = pos < offset
    if window is not None:
        valid = valid & ((offset - pos) <= window)
    scores = (qg.double() @ kc.transpose(-1, -2)).float()  # [B, Hkv, G, S]
    scores = torch.where(valid, scores, float("-inf"))
    self_s = _sum64(qg.double() * k[:, :, None].double())  # [B, Hkv, G]
    m = torch.maximum(scores.amax(-1), self_s)
    e_cache = torch.exp(scores - m[..., None])
    e_self = torch.exp(self_s - m)
    denom = _sum64(e_cache) + e_self
    ctx = (e_cache.double() @ vc).float() + e_self[..., None] * v[:, :, None]
    return (ctx / denom[..., None]).reshape(B, n_heads * hd)


def layer_attention_split_plain(q, k, v, k_cache, v_cache, offset: int,
                                window, n_kv: int, scale: float,
                                pieces: int) -> torch.Tensor:
    """What K7's attention (``csrc/decode_layer.cu`` ``attn_group_kernel``)
    computes, written plainly: the arguments of
    :func:`_layer_attention_plain` and ``pieces`` = P, the blocks of the
    cluster that walks each (row, kv head).

    The visible slots [max(0, offset - window), min(offset, S)) are cut
    into P contiguous pieces of ceil(n / P) slots (pieces past the end
    empty).  Per piece: the scores (f32 q x bf16 k in f64, rounded to
    f32) and their max; the max over every piece and the self score; per
    piece the f64 sum of expf(s - m) and the P.V partial (f32 weights x
    bf16 v in f64); the partials added in piece order and rounded once,
    then the self term in f32 as :func:`_layer_attention_plain` adds it.
    Nothing here rounds where the unsplit walk does not, and the f64 sums
    of exact products do not depend on their order, so the result equals
    :func:`_layer_attention_plain` bit for bit for every P."""
    B, n_heads, hd = q.shape
    S = k_cache.shape[1]
    G = n_heads // n_kv
    lo = max(0, offset - window) if window is not None else 0
    hi = min(offset, S)
    n = max(hi - lo, 0)
    piece = -(-n // pieces) if n else 0
    qg = (q * scale).reshape(B, n_kv, G, hd).double()
    self_s = _sum64(qg * k[:, :, None].double())  # [B, Hkv, G]
    kc = k_cache.permute(0, 2, 1, 3).double()  # [B, Hkv, S, hd]
    vc = v_cache.permute(0, 2, 1, 3).double()
    bounds = [(min(lo + r * piece, hi), min(lo + (r + 1) * piece, hi))
              for r in range(pieces)]
    scores = [(qg @ kc[:, :, a:b].transpose(-1, -2)).float()
              for a, b in bounds]
    m = self_s
    for sc in scores:
        if sc.shape[-1]:
            m = torch.maximum(m, sc.amax(-1))
    den = torch.zeros_like(self_s, dtype=torch.float64)
    ctx = torch.zeros((B, n_kv, G, hd), dtype=torch.float64,
                      device=q.device)
    for (a, b), sc in zip(bounds, scores):
        e = torch.exp(sc - m[..., None]).double()
        den = den + e.sum(dim=-1)
        ctx = ctx + e @ vc[:, :, a:b]
    e_self = torch.exp(self_s - m)
    out = ((ctx.float() + e_self[..., None] * v[:, :, None])
           / (den.float() + e_self)[..., None])
    return out.reshape(B, n_heads * hd)


def decode_layer_step_plain(
    x, layer: int, offset: int,
    attn_norm, ffn_norm, ada_vec,
    sqkv, so, s13, s2, cos_p, sin_p,
    k_cache, v_cache,
    wqkv, wo, w13, w2,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None,
):
    """Plain PyTorch version of K7, as the JAX kernel computes it: the
    float reductions in f64, rounded once (as the CUDA kernel).  Returns
    (x_out [B, D] f32, k_new, v_new [B, Hkv, hd] in the cache dtype)."""
    nq, nkv = n_heads * head_dim, n_kv * head_dim
    hidden = w2.shape[2]
    B = x.shape[0]
    c, s = cos_p.float(), sin_p.float()
    x = x.float()

    def lin(h, w, sc):
        xq, sx = _quant(h)
        return w8_matmul_plain(xq, sx, w[layer], sc)

    h = _rms(x, attn_norm.float(), eps)
    qkv = lin(h, wqkv, sqkv)
    q = qkv[:, :nq].reshape(B, n_heads, head_dim)
    k = qkv[:, nq:nq + nkv].reshape(B, n_kv, head_dim)
    v = qkv[:, nq + nkv:].reshape(B, n_kv, head_dim)
    q = q * c + _rope_swap(q) * s
    k = k * c + _rope_swap(k) * s
    attn = _layer_attention_plain(q, k, v, k_cache, v_cache, offset, window,
                                  n_kv, head_dim ** -0.5)
    x = x + lin(attn, wo, so)
    h = _rms(x, ffn_norm.float(), eps) * ada_vec.float()
    up = lin(h, w13, s13)
    gate, upv = up[:, :hidden], up[:, hidden:]
    x = x + lin(gate * (1.0 / (1.0 + torch.exp(-gate))) * upv, w2, s2)
    return x, k.to(k_cache.dtype), v.to(v_cache.dtype)


def layer_smem_bytes(S: int, head_dim: int,
                     window: Optional[int] = None) -> int:
    """Shared memory of one K7 attention block, as the host entry sizes
    it: the per-warp P.V partials (f64), q, k, v and one score per slot
    the window lets a row see."""
    span = window if window is not None and window < S else S
    return 8 * (ATTN_THREADS // 32) * head_dim + 4 * (3 * head_dim + span)


def check_layer_geometry(S: int, head_dim: int,
                         window: Optional[int] = None) -> None:
    """ValueError naming the cause when K7 cannot take a cache of S
    slots: its score buffer lives in one block's shared memory."""
    need = layer_smem_bytes(S, head_dim, window)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"decode_layer_step: a cache of {S} slots (window {window}) "
            f"needs {need} bytes of shared memory per attention block, "
            f"above the {SMEM_LIMIT} a block may hold")


# K7's attention (csrc/decode_layer.cu): the fewest visible slots a
# block takes before the walk is cut over a cluster, the attention blocks
# a call aims at (rows x kv heads x pieces), and the largest cluster.
K7_PIECE_SLOTS = 32
K7_BLOCKS = 128
K7_MAX_PIECES = 8
K7_PDL = True   # False: the layer's launches in plain stream order


def layer_attn_plan(S: int, offset: int, window: Optional[int], rows: int,
                    n_kv: int) -> tuple:
    """(pieces, piece) of K7's attention at one call: the visible slots
    cut into ``pieces`` blocks of ``piece`` slots, one cluster per (row,
    kv head): at most 8, at most K7_BLOCKS / (rows x n_kv), and no piece
    below K7_PIECE_SLOTS slots (one block where the span is short).
    Tuned on the H100 at layer 25's shapes
    (``benches/torch_k3_k7_times.py``)."""
    lo = max(0, offset - window) if window is not None else 0
    n = max(min(offset, S) - lo, 0)
    pieces = max(1, min(K7_MAX_PIECES, -(-n // K7_PIECE_SLOTS),
                        K7_BLOCKS // (rows * n_kv)))
    return pieces, -(-n // pieces)


@functools.lru_cache(maxsize=4096)
def layer_attn_scratch(n_heads: int, n_kv: int, head_dim: int,
                       piece: int) -> int:
    """Bytes a block of K7's attention needs outside shared memory for
    its scores and softmax weights at ``piece`` slots a block, 0 where
    they fit: from the built library (``vx_layer_attn_scratch``, the
    layout of ``csrc/decode_layer.cu::attn_geometry``)."""
    out = ctypes.c_longlong()
    fn = kernel_fn("vx_layer_attn_scratch", [_I] * 3 + [ctypes.c_void_p])
    code = fn(n_heads // n_kv, head_dim, piece,
              ctypes.cast(ctypes.byref(out), ctypes.c_void_p))
    check(code, "layer_attn_scratch")
    if out.value < 0:
        raise ValueError(f"decode_layer_step: no attention layout fits "
                         f"G={n_heads // n_kv} head_dim={head_dim}")
    return out.value


def decode_layer_step(
    x, layer: int, offset: int,
    attn_norm, ffn_norm, ada_vec,
    sqkv, so, s13, s2, cos_p, sin_p,
    k_cache, v_cache,
    wqkv, wo, w13, w2,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None,
):
    """K7: one decoder layer of a single-token w8 decode step (JAX
    ``decode_layer_step``, ``decode_step_pallas.py:292``).

    x [B, D] f32; ``layer`` and ``offset`` ints (the query position, the
    cache slots below it written); layer ``layer``'s attn_norm, ffn_norm,
    ada_vec [D] and row scales sqkv [NQKV], so [D], s13 [2F], s2 [D] f32;
    cos_p / sin_p [hd] f32 pair-expanded at ``offset``; caches
    position-major [B, S, Hkv, hd] bf16 (this layer's slice of the
    prefill cache, read at slots < offset only); the stacked w8 codes
    wqkv [L, NQKV, D], wo [L, D, NQ], w13 [L, 2F, D], w2 [L, D, F] int8,
    indexed by ``layer`` inside; ``window`` the sliding window (None: no
    lower bound).  Returns (x_out [B, D] f32, k_new, v_new [B, Hkv, hd]
    bf16); the caller appends them at ``offset``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (source ``csrc/decode_layer.cu``: nine launches, programmatic
    dependent ones unless :data:`K7_PDL` is False; the attention a block
    or a cluster per (row, kv head) as :func:`layer_attn_plan` cuts the
    visible slots) or raise.  Each call adds one to
    ``decode_layer_step.launches``.
    """
    args = (x, layer, offset, attn_norm, ffn_norm, ada_vec, sqkv, so, s13,
            s2, cos_p, sin_p, k_cache, v_cache, wqkv, wo, w13, w2)
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps,
              window=window)
    dev = x.device
    if dev.type == "cpu":
        return decode_layer_step_plain(*args, **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"decode_layer_step: unsupported device {dev}")

    def need(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"decode_layer_step: {msg}")

    B, D = x.shape
    _, S, Hkv, hd = k_cache.shape
    L = wqkv.shape[0]
    nq, nkvd = n_heads * head_dim, n_kv * head_dim
    F = w2.shape[2]
    need(isinstance(layer, int) and 0 <= layer < L,
         f"layer must be an int in [0, {L}), got {layer!r}")
    need(isinstance(offset, int) and 0 <= offset <= S,
         f"offset must be an int in [0, {S}], got {offset!r}")
    need(Hkv == n_kv and hd == head_dim,
         f"cache {tuple(k_cache.shape)} does not match n_kv={n_kv}, "
         f"head_dim={head_dim}")
    need(head_dim % 16 == 0 and 512 % head_dim == 0
         and n_heads % n_kv == 0 and n_heads // n_kv in (1, 2, 4, 8),
         "head_dim must be 16, 32, 64, 128 or 256 and n_kv must divide "
         "n_heads in groups of 1, 2, 4 or 8")
    check_layer_geometry(S, head_dim, window)
    f32 = torch.float32
    expect = {
        "x": (x, f32, (B, D)),
        "attn_norm": (attn_norm, f32, (D,)),
        "ffn_norm": (ffn_norm, f32, (D,)),
        "ada_vec": (ada_vec, f32, (D,)),
        "sqkv": (sqkv, f32, (nq + 2 * nkvd,)),
        "so": (so, f32, (D,)),
        "s13": (s13, f32, (2 * F,)),
        "s2": (s2, f32, (D,)),
        "cos_p": (cos_p, f32, (head_dim,)),
        "sin_p": (sin_p, f32, (head_dim,)),
        "k_cache": (k_cache, torch.bfloat16, (B, S, n_kv, head_dim)),
        "v_cache": (v_cache, torch.bfloat16, (B, S, n_kv, head_dim)),
        "wqkv": (wqkv, torch.int8, (L, nq + 2 * nkvd, D)),
        "wo": (wo, torch.int8, (L, D, nq)),
        "w13": (w13, torch.int8, (L, 2 * F, D)),
        "w2": (w2, torch.int8, (L, D, F)),
    }
    for name, (t, dtype, shape) in expect.items():
        need(t is not None and t.dtype == dtype
             and tuple(t.shape) == shape,
             f"{name} must be {dtype} {shape}, got "
             f"{None if t is None else (t.dtype, tuple(t.shape))}")
        need(t.device == dev and t.is_contiguous(),
             f"{name} must be contiguous on {dev}")
    need(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
         "the caches must be 16-byte aligned")

    x_out = torch.empty((B, D), dtype=f32, device=dev)
    k_new = torch.empty((B, n_kv, head_dim), dtype=torch.bfloat16,
                        device=dev)
    v_new = torch.empty_like(k_new)
    xq_buf = torch.empty((B, max(D, nq, F)), dtype=torch.int8, device=dev)
    sx_buf = torch.empty((B,), dtype=f32, device=dev)
    qkv_buf = torch.empty((B, nq + 2 * nkvd), dtype=f32, device=dev)
    attn_buf = torch.empty((B, nq), dtype=f32, device=dev)
    up_buf = torch.empty((B, 2 * F), dtype=f32, device=dev)
    pieces, piece = layer_attn_plan(S, offset, window, B, n_kv)
    with torch.cuda.device(dev):
        scratch = layer_attn_scratch(n_heads, n_kv, head_dim, piece)
        scores_buf = (torch.empty((B * n_kv * pieces * scratch,),
                                  dtype=torch.uint8, device=dev)
                      if scratch else None)
        fn = kernel_fn("vx_decode_layer_step",
                       [_P, _P, _I, _I] + [_P] * 23 + [_I] * 8 + [_F, _F]
                       + [_I] * 3 + [_P])
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            x.data_ptr(), x_out.data_ptr(), layer, offset,
            attn_norm.data_ptr(), ffn_norm.data_ptr(), ada_vec.data_ptr(),
            sqkv.data_ptr(),
            so.data_ptr(), s13.data_ptr(), s2.data_ptr(), cos_p.data_ptr(),
            sin_p.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            wqkv.data_ptr(), wo.data_ptr(), w13.data_ptr(), w2.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), xq_buf.data_ptr(),
            sx_buf.data_ptr(), qkv_buf.data_ptr(), attn_buf.data_ptr(),
            up_buf.data_ptr(),
            None if scores_buf is None else scores_buf.data_ptr(),
            B, D, S, n_heads, n_kv, head_dim, F,
            -1 if window is None else int(window), eps, head_dim ** -0.5,
            pieces, piece, int(K7_PDL), stream)
    check(code, "decode_layer_step")
    decode_layer_step.launches += 1
    return x_out, k_new, v_new


decode_layer_step.launches = 0
