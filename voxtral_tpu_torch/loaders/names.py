"""Canonical weight-name tables for the Voxtral SafeTensors/GGUF checkpoints.

Mirrors the reference's name functions (``voxtral-mini-realtime-rs/src/models/weights.rs:219-396``).
The GGUF export uses the SAME tensor names.

The port's own copy of ``voxtral_tpu/loaders/names.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

ENCODER_PREFIX = "mm_streams_embeddings.embedding_module.whisper_encoder"
DECODER_PREFIX = "layers"
TOK_EMBEDDINGS = "mm_streams_embeddings.embedding_module.tok_embeddings.weight"
ADAPTER_PREFIX = "mm_streams_embeddings.embedding_module.audio_language_projection"
FINAL_NORM = "norm.weight"
ENCODER_FINAL_NORM = f"{ENCODER_PREFIX}.transformer.norm.weight"


def encoder_layer_names(i: int) -> dict[str, str]:
    p = f"{ENCODER_PREFIX}.transformer.layers.{i}"
    return {
        "attention_norm": f"{p}.attention_norm.weight",
        "wq_weight": f"{p}.attention.wq.weight",
        "wq_bias": f"{p}.attention.wq.bias",
        "wk_weight": f"{p}.attention.wk.weight",
        "wv_weight": f"{p}.attention.wv.weight",
        "wv_bias": f"{p}.attention.wv.bias",
        "wo_weight": f"{p}.attention.wo.weight",
        "wo_bias": f"{p}.attention.wo.bias",
        "ffn_norm": f"{p}.ffn_norm.weight",
        "w1_weight": f"{p}.feed_forward.w1.weight",
        "w2_weight": f"{p}.feed_forward.w2.weight",
        "w2_bias": f"{p}.feed_forward.w2.bias",
        "w3_weight": f"{p}.feed_forward.w3.weight",
    }


def decoder_layer_names(i: int) -> dict[str, str]:
    p = f"{DECODER_PREFIX}.{i}"
    return {
        "ada_norm_down": f"{p}.ada_rms_norm_t_cond.0.weight",
        "ada_norm_up": f"{p}.ada_rms_norm_t_cond.2.weight",
        "attention_norm": f"{p}.attention_norm.weight",
        "wq_weight": f"{p}.attention.wq.weight",
        "wk_weight": f"{p}.attention.wk.weight",
        "wv_weight": f"{p}.attention.wv.weight",
        "wo_weight": f"{p}.attention.wo.weight",
        "ffn_norm": f"{p}.ffn_norm.weight",
        "w1_weight": f"{p}.feed_forward.w1.weight",
        "w2_weight": f"{p}.feed_forward.w2.weight",
        "w3_weight": f"{p}.feed_forward.w3.weight",
    }


def conv_names() -> dict[str, str]:
    return {
        "conv1_weight": f"{ENCODER_PREFIX}.conv_layers.0.conv.weight",
        "conv1_bias": f"{ENCODER_PREFIX}.conv_layers.0.conv.bias",
        "conv2_weight": f"{ENCODER_PREFIX}.conv_layers.1.conv.weight",
        "conv2_bias": f"{ENCODER_PREFIX}.conv_layers.1.conv.bias",
    }


def adapter_names() -> dict[str, str]:
    return {
        "linear1_weight": f"{ADAPTER_PREFIX}.0.weight",
        "linear2_weight": f"{ADAPTER_PREFIX}.2.weight",
    }
