"""Language-model decoder (port of ``voxtral_tpu/models/decoder.py``):
26-layer GQA 32Q/8KV with ADA t-conditioning and a tied lm_head.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from voxtral_tpu_torch.config import LanguageModelConfig
from voxtral_tpu_torch.models.layers import (
    AttentionSpec,
    KVCache,
    decoder_block_with_cache,
    layer_params,
    n_stacked,
    rms_norm,
    rope_tables,
)
from voxtral_tpu_torch.ops.q4 import q4_dequant_rows, q4_matmul
from voxtral_tpu_torch.ops.w8 import w8_dequant_rows, w8_matmul

Params = dict[str, Any]

# RoPE table length of the decoder (the reference builds 16384).
DECODER_ROPE_MAX_SEQ = 16384


def decoder_spec(cfg: LanguageModelConfig) -> AttentionSpec:
    return AttentionSpec(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        sliding_window=cfg.sliding_window,
        causal=cfg.causal,
    )


def embed_tokens(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] int -> [B, S, d_model] embeddings: rows of a dense table in
    its dtype, or of the w8 / q4 table gathered and dequantized on the
    device (bf16)."""
    emb = params["tok_embeddings"]
    if not isinstance(emb, dict):
        return emb[token_ids.long()]
    if "q4" in emb:
        return q4_dequant_rows(emb["q4"], token_ids)
    return w8_dequant_rows(emb["w8"], token_ids)


# Vocab rows per f32 product of the dense lm_head: bounds its f32 copy of
# the table (131072 x 3072 bf16 would take 1.6 GB at once).
LM_ROWS = 16384


def lm_head(params: Params, hidden: torch.Tensor, mm=None) -> torch.Tensor:
    """Tied embeddings: logits = hidden @ E^T in f32.  ``mm`` as in
    :func:`voxtral_tpu_torch.models.layers.linear`.  A dense table sums
    its products in f32 (JAX's einsum with ``preferred_element_type=
    f32``), over vocab blocks of :data:`LM_ROWS` rows."""
    emb = params["tok_embeddings"]
    if not isinstance(emb, dict):
        h = hidden.float()
        return torch.cat([h @ emb[v:v + LM_ROWS].float().mT
                          for v in range(0, emb.shape[0], LM_ROWS)], dim=-1)
    if "q4" in emb:
        return q4_matmul(hidden, emb["q4"], mm=mm and mm.q4)
    return w8_matmul(hidden, emb["w8"], mm=mm and mm.w8)


def decoder_forward_hidden_with_cache(
    params: Params, hidden: torch.Tensor, t_embed: torch.Tensor,
    cache: KVCache, cfg: LanguageModelConfig,
    rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None, mm=None,
    pos_base: int = 0, ring: Optional[tuple[int, int]] = None,
) -> tuple[torch.Tensor, KVCache]:
    """Forward over hidden [B, S, d_model] appending at ``cache.length``.

    ``pos_base``: absolute position of cache slot 0; ``ring``: (head,
    size) head+ring cache layout (see ``layers.attention_with_cache``).
    Returns (final-normed hidden, cache); the cache arrays are written
    in place.
    """
    spec = decoder_spec(cfg)
    if rope is None:
        rope = rope_tables(cfg.head_dim, cache.max_seq, cfg.rope_theta,
                           device=hidden.device)
    cos, sin = rope
    offset = cache.length
    layers = params["layers"]
    x = hidden
    for l in range(n_stacked(layers)):
        x, _, _ = decoder_block_with_cache(
            x, t_embed, layer_params(layers, l), spec, cos, sin,
            cache.k[l], cache.v[l], offset, cfg.norm_eps, mm, pos_base, ring)
    cache = KVCache(cache.k, cache.v, offset + hidden.shape[1])
    return rms_norm(x, params["norm"], cfg.norm_eps), cache


def create_cache(cfg: LanguageModelConfig, batch: int, max_seq: int,
                 dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache.create(cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device)
