"""Host-side (numpy) builders of w8 parameter trees.

numpy copies of ``voxtral_tpu/utils/quantize.py::random_w8_params`` and
``::quantize_params_w8`` (that module reaches jax through ``ops/q4.py``).
The trees are the JAX package's own format — numpy leaves,
``{"w8": {"codes", "scale"}}`` dicts, bfloat16 ``ml_dtypes`` arrays and
``[L, ...]`` stacks — so one tree feeds both packages
(:func:`voxtral_tpu_torch.convert.params_from_numpy` moves it to torch).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from voxtral_tpu_torch.ops.w8 import quantize_w8_rowwise

Params = dict[str, Any]

# Leaf names that are weight matrices, per parent dict.
_LINEAR_KEYS = {
    "attention": {"wq", "wk", "wv", "wo"},
    "ffn": {"w1", "w2", "w3"},
    "ada": {"w0", "w2"},
    "adapter": {"w1", "w2"},
}


def _rand_w8(rng, *shape) -> dict:
    """Random {"w8": ...} leaf; shape = ([L,] N, K).

    Stacked layers tile ONE random matrix (throughput is value-
    independent, and generating 4B+ random ints dominates init time).
    """
    if len(shape) == 3:
        layer = rng.integers(-127, 128, size=shape[1:], dtype=np.int8)
        codes = np.broadcast_to(layer, shape).copy()
    else:
        codes = rng.integers(-127, 128, size=shape, dtype=np.int8)
    return {"w8": {
        "codes": codes,
        "scale": np.full(shape[:-1], 2e-4, dtype=np.float32),
    }}


def random_w8_params(cfg, seed: int = 0) -> Params:
    """Random production-shape W8A8 params, built on the host."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    e, l, a = cfg.audio_encoder, cfg.language_model, cfg.adapter
    tc = cfg.ada_rms_norm_t_cond_dim or 32
    bf16 = np.dtype(ml_dtypes.bfloat16)

    def rand_dense(*s):
        return (rng.normal(size=s).astype(np.float32) * 0.02).astype(bf16)

    qd_e = e.n_heads * e.head_dim
    encoder = {
        "conv": {
            "conv1": rand_dense(e.dim, 128, 3), "conv1_b": np.zeros(e.dim, bf16),
            "conv2": rand_dense(e.dim, e.dim, 3), "conv2_b": np.zeros(e.dim, bf16),
        },
        "layers": {
            "attention_norm": np.ones((e.n_layers, e.dim), bf16),
            "attention": {
                "wq": _rand_w8(rng, e.n_layers, qd_e, e.dim),
                "wq_b": np.zeros((e.n_layers, qd_e), bf16),
                "wk": _rand_w8(rng, e.n_layers, qd_e, e.dim),
                "wv": _rand_w8(rng, e.n_layers, qd_e, e.dim),
                "wv_b": np.zeros((e.n_layers, qd_e), bf16),
                "wo": _rand_w8(rng, e.n_layers, e.dim, qd_e),
                "wo_b": np.zeros((e.n_layers, e.dim), bf16),
            },
            "ffn_norm": np.ones((e.n_layers, e.dim), bf16),
            "ffn": {
                "w1": _rand_w8(rng, e.n_layers, e.hidden_dim, e.dim),
                "w2": _rand_w8(rng, e.n_layers, e.dim, e.hidden_dim),
                "w2_b": np.zeros((e.n_layers, e.dim), bf16),
                "w3": _rand_w8(rng, e.n_layers, e.hidden_dim, e.dim),
            },
        },
        "norm": np.ones(e.dim, bf16),
    }
    qd = l.n_heads * l.head_dim
    kvd = l.n_kv_heads * l.head_dim
    decoder = {
        "tok_embeddings": _rand_w8(rng, l.vocab_size, l.dim),
        "layers": {
            "ada": {
                "w0": _rand_w8(rng, l.n_layers, tc, l.dim),
                "w2": _rand_w8(rng, l.n_layers, l.dim, tc),
            },
            "attention_norm": np.ones((l.n_layers, l.dim), bf16),
            "attention": {
                "wq": _rand_w8(rng, l.n_layers, qd, l.dim),
                "wk": _rand_w8(rng, l.n_layers, kvd, l.dim),
                "wv": _rand_w8(rng, l.n_layers, kvd, l.dim),
                "wo": _rand_w8(rng, l.n_layers, l.dim, qd),
            },
            "ffn_norm": np.ones((l.n_layers, l.dim), bf16),
            "ffn": {
                "w1": _rand_w8(rng, l.n_layers, l.hidden_dim, l.dim),
                "w2": _rand_w8(rng, l.n_layers, l.dim, l.hidden_dim),
                "w3": _rand_w8(rng, l.n_layers, l.hidden_dim, l.dim),
            },
        },
        "norm": np.ones(l.dim, bf16),
    }
    adapter = {
        "w1": _rand_w8(rng, a.output_dim, a.input_dim),
        "w2": _rand_w8(rng, a.output_dim, a.output_dim),
    }
    return {"encoder": encoder, "decoder": decoder, "adapter": adapter}


def quantize_params_w8(params: Params) -> Params:
    """Quantize a dense numpy tree's linears + embeddings to rowwise int8.

    Dense linears are stored [in, out] ([L, in, out] for stacks); the
    codes are [out, in] per layer, quantized along the in-features axis.
    """

    def q_matrix(w_nk):
        return quantize_w8_rowwise(np.asarray(w_nk, dtype=np.float32))

    def walk(node, parent_key: str):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val, key)
            elif key == "tok_embeddings":
                out[key] = q_matrix(val)  # [V, D]
            elif (key in _LINEAR_KEYS.get(parent_key, set())
                  and getattr(val, "ndim", 0) >= 2):
                w = np.asarray(val, dtype=np.float32)
                if w.ndim == 3:  # [L, in, out] -> per-layer [out, in]
                    per = [q_matrix(w[i].T)["w8"] for i in range(w.shape[0])]
                    out[key] = {"w8": {
                        "codes": np.stack([p["codes"] for p in per]),
                        "scale": np.stack([p["scale"] for p in per]),
                    }}
                else:
                    out[key] = q_matrix(w.T)
            else:
                out[key] = val
        return out

    return {
        "encoder": walk(params["encoder"], "encoder"),
        "decoder": walk(params["decoder"], "decoder"),
        "adapter": walk(params["adapter"], "adapter"),
    }
