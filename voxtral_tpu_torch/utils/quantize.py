"""Construction of random and quantized parameter trees.

Host-side (numpy) copies of ``voxtral_tpu/utils/quantize.py``'s
``random_w8_params``, ``quantize_params_w8``, ``random_q4_params`` and
``quantize_params_q4`` (the port imports nothing of the JAX package).
Those trees are the JAX package's own format — numpy leaves,
``{"w8": {"codes", "scale"}}`` dicts, bfloat16 ``ml_dtypes`` arrays and
``[L, ...]`` stacks — so one tree feeds both packages
(:func:`voxtral_tpu_torch.convert.params_from_numpy` moves it to torch).

:func:`random_dense_params`, the counterpart of JAX's
``VoxtralModel.init_random``, builds its dense tree on the device from a
seeded ``torch.Generator`` instead: 4.3 billion normal draws take
minutes in numpy.  Its values are not ``jax.random``'s; tests carry the
JAX tree across through numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from voxtral_tpu_torch.device import DeviceLike, resolve_device
from voxtral_tpu_torch.ops.q4 import quantize_q4_0, repack_q4_0
from voxtral_tpu_torch.ops.q4_kernel import pack_codes, transpose_scales
from voxtral_tpu_torch.ops.w8 import quantize_w8_rowwise

Params = dict[str, Any]

# Leaf names that are weight matrices, per parent dict.
_LINEAR_KEYS = {
    "attention": {"wq", "wk", "wv", "wo"},
    "ffn": {"w1", "w2", "w3"},
    "ada": {"w0", "w2"},
    "adapter": {"w1", "w2"},
}


def _quantize_matrix(w_nk: np.ndarray, pack: bool = True) -> dict:
    """[N, K] f32 -> q4 leaf (packed where K3 takes the shape: K % 256
    == 0 and N % 128 == 0), or None when K % 32 != 0 (kept dense).

    ``pack=False`` keeps the unpacked {codes, f16 scales} form (q4g)."""
    n, k = w_nk.shape
    if k % 32 != 0:
        return None
    q4 = repack_q4_0(quantize_q4_0(w_nk), (n, k))
    if pack and k % 256 == 0 and n % 128 == 0:
        q4 = {
            "codes_packed": pack_codes(q4["codes"]),
            "scales_t": transpose_scales(q4["scales"]),
        }
    return {"q4": q4}


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


def random_dense_params(cfg, seed: int = 0, dtype=torch.bfloat16,
                        device: DeviceLike = None,
                        scale: float = 0.02) -> Params:
    """Random dense weights at the configuration's shapes, built on
    ``device`` (``None``: the card): the layout and the draws' law of
    JAX's ``init_encoder_params`` / ``init_decoder_params`` /
    ``init_adapter_params`` (normal(0, ``scale``) linears [in, out] and
    conv kernels, zero biases, unit norms; JAX draws with 0.02), in
    ``dtype`` (bf16 or f32).
    Every draw comes from one ``torch.Generator`` seeded with ``seed``,
    a layer (or 16384 table rows) at a time, so the f32 draws never
    outgrow one layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    e, lm, a = cfg.audio_encoder, cfg.language_model, cfg.adapter
    tc = cfg.ada_rms_norm_t_cond_dim or 32

    def init(*shape):
        out = torch.empty(shape, dtype=dtype, device=dev)
        step = 16384 if len(shape) == 2 else 1
        for i in range(0, shape[0], step):
            part = out[i:i + step]
            part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                       * scale)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    L, d, f = e.n_layers, e.dim, e.hidden_dim
    q = e.n_heads * e.head_dim
    encoder = {
        "conv": {"conv1": init(d, 128, 3), "conv1_b": zeros(d),
                 "conv2": init(d, d, 3), "conv2_b": zeros(d)},
        "layers": {
            "attention_norm": ones(L, d),
            "attention": {"wq": init(L, d, q), "wq_b": zeros(L, q),
                          "wk": init(L, d, q), "wv": init(L, d, q),
                          "wv_b": zeros(L, q), "wo": init(L, q, d),
                          "wo_b": zeros(L, d)},
            "ffn_norm": ones(L, d),
            "ffn": {"w1": init(L, d, f), "w2": init(L, f, d),
                    "w2_b": zeros(L, d), "w3": init(L, d, f)},
        },
        "norm": ones(d),
    }
    L, d, f = lm.n_layers, lm.dim, lm.hidden_dim
    nq, nkv = lm.n_heads * lm.head_dim, lm.n_kv_heads * lm.head_dim
    decoder = {
        "tok_embeddings": init(lm.vocab_size, d),
        "layers": {
            "ada": {"w0": init(L, d, tc), "w2": init(L, tc, d)},
            "attention_norm": ones(L, d),
            "attention": {"wq": init(L, d, nq), "wk": init(L, d, nkv),
                          "wv": init(L, d, nkv), "wo": init(L, nq, d)},
            "ffn_norm": ones(L, d),
            "ffn": {"w1": init(L, d, f), "w2": init(L, f, d),
                    "w3": init(L, d, f)},
        },
        "norm": ones(d),
    }
    adapter = {"w1": init(a.input_dim, lm.dim),
               "w2": init(lm.dim, a.output_dim)}
    return {"encoder": encoder, "decoder": decoder, "adapter": adapter}


def quantize_params_w8(params: Params) -> Params:
    """Quantize a dense tree's linears + embeddings to rowwise int8.

    Dense linears are stored [in, out] ([L, in, out] for stacks); the
    codes are [out, in] per layer, quantized along the in-features axis.
    A numpy tree gives numpy leaves; a tree of tensors (such as
    :func:`random_dense_params`') is quantized on its device, which at
    full width takes seconds where numpy takes minutes.
    """

    def q_matrix(w_nk):
        if isinstance(w_nk, torch.Tensor):
            return quantize_w8_rowwise(w_nk)
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
                if isinstance(val, torch.Tensor):  # [L, in, out] at once
                    out[key] = q_matrix(val.transpose(-1, -2))
                    continue
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


def random_q4_params(cfg, seed: int = 0, pack: bool = True) -> Params:
    """Random production-shape Q4_0 params, built on the host: every
    linear quantized from normal(0, 0.02) draws, one draw per layer
    (the JAX package's draw order, so the trees are equal).  ``pack``
    as in :func:`_quantize_matrix`."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    e, l, a = cfg.audio_encoder, cfg.language_model, cfg.adapter
    tc = cfg.ada_rms_norm_t_cond_dim or 32
    bf16 = np.dtype(ml_dtypes.bfloat16)

    def rand_q4(n, k):
        return _quantize_matrix(
            rng.normal(size=(n, k)).astype(np.float32) * 0.02, pack=pack)

    def rand_q4_stack(n_layers, n, k):
        qs = [rand_q4(n, k) for _ in range(n_layers)]
        return {"q4": {kk: np.stack([q["q4"][kk] for q in qs])
                       for kk in qs[0]["q4"]}}

    def rand_dense(*shape):
        return (rng.normal(size=shape).astype(np.float32) * 0.02).astype(bf16)

    qd_e = e.n_heads * e.head_dim
    encoder = {
        "conv": {
            "conv1": rand_dense(e.dim, 128, 3), "conv1_b": np.zeros(e.dim, bf16),
            "conv2": rand_dense(e.dim, e.dim, 3), "conv2_b": np.zeros(e.dim, bf16),
        },
        "layers": {
            "attention_norm": np.ones((e.n_layers, e.dim), bf16),
            "attention": {
                "wq": rand_q4_stack(e.n_layers, qd_e, e.dim),
                "wq_b": np.zeros((e.n_layers, qd_e), bf16),
                "wk": rand_q4_stack(e.n_layers, qd_e, e.dim),
                "wv": rand_q4_stack(e.n_layers, qd_e, e.dim),
                "wv_b": np.zeros((e.n_layers, qd_e), bf16),
                "wo": rand_q4_stack(e.n_layers, e.dim, qd_e),
                "wo_b": np.zeros((e.n_layers, e.dim), bf16),
            },
            "ffn_norm": np.ones((e.n_layers, e.dim), bf16),
            "ffn": {
                "w1": rand_q4_stack(e.n_layers, e.hidden_dim, e.dim),
                "w2": rand_q4_stack(e.n_layers, e.dim, e.hidden_dim),
                "w2_b": np.zeros((e.n_layers, e.dim), bf16),
                "w3": rand_q4_stack(e.n_layers, e.hidden_dim, e.dim),
            },
        },
        "norm": np.ones(e.dim, bf16),
    }
    qd = l.n_heads * l.head_dim
    kvd = l.n_kv_heads * l.head_dim
    decoder = {
        "tok_embeddings": rand_q4(l.vocab_size, l.dim),
        "layers": {
            "ada": {
                "w0": rand_q4_stack(l.n_layers, tc, l.dim),
                "w2": rand_q4_stack(l.n_layers, l.dim, tc),
            },
            "attention_norm": np.ones((l.n_layers, l.dim), bf16),
            "attention": {
                "wq": rand_q4_stack(l.n_layers, qd, l.dim),
                "wk": rand_q4_stack(l.n_layers, kvd, l.dim),
                "wv": rand_q4_stack(l.n_layers, kvd, l.dim),
                "wo": rand_q4_stack(l.n_layers, l.dim, qd),
            },
            "ffn_norm": np.ones((l.n_layers, l.dim), bf16),
            "ffn": {
                "w1": rand_q4_stack(l.n_layers, l.hidden_dim, l.dim),
                "w2": rand_q4_stack(l.n_layers, l.dim, l.hidden_dim),
                "w3": rand_q4_stack(l.n_layers, l.hidden_dim, l.dim),
            },
        },
        "norm": np.ones(l.dim, bf16),
    }
    adapter = {
        "w1": rand_q4(a.output_dim, a.input_dim),
        "w2": rand_q4(a.output_dim, a.output_dim),
    }
    return {"encoder": encoder, "decoder": decoder, "adapter": adapter}


def quantize_params_q4(params: Params, pack: bool = True) -> Params:
    """Quantize a dense numpy tree's attention / FFN / ADA / adapter
    linears and tok_embeddings to Q4_0 (norms, biases and the conv stay
    dense, as the GGUF export keeps them).  ``pack`` as in
    :func:`_quantize_matrix`; a matrix whose K is not a multiple of 32
    stays dense."""

    def walk(node, parent_key: str):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val, key)
            elif key == "tok_embeddings":
                q = _quantize_matrix(np.asarray(val, dtype=np.float32),
                                     pack=pack)  # [V, D]: K = D
                out[key] = q if q is not None else val
            elif (key in _LINEAR_KEYS.get(parent_key, set())
                  and getattr(val, "ndim", 0) >= 2):
                w = np.asarray(val, dtype=np.float32)
                if w.ndim == 3:  # [L, in, out] -> per-layer [out, in]
                    qs = [_quantize_matrix(w[i].T, pack=pack)
                          for i in range(w.shape[0])]
                    if any(q is None for q in qs):
                        out[key] = val
                    else:
                        out[key] = {"q4": {
                            kk: np.stack([q["q4"][kk] for q in qs])
                            for kk in qs[0]["q4"]}}
                else:
                    q = _quantize_matrix(w.T, pack=pack)
                    out[key] = q if q is not None else val
            else:
                out[key] = val
        return out

    return {
        "encoder": walk(params["encoder"], "encoder"),
        "decoder": walk(params["decoder"], "decoder"),
        "adapter": walk(params["adapter"], "adapter"),
    }
