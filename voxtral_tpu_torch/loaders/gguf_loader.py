"""Q4_0 GGUF model loading into the port's parameter tree (port of
``voxtral_tpu/loaders/gguf_loader.py``).

The GGUF export uses the SafeTensors checkpoint's tensor names; the
weight-heavy linears and the token-embedding table are Q4_0, while
norms, biases and the conv downsampler stay F32.  Dims are reversed from
GGUF order.  The tree is built in numpy, leaf for leaf the JAX loader's
(its numpy repack path; the JAX package's optional C++ repacker computes
the same arrays), then moved to the device by
:func:`voxtral_tpu_torch.convert.params_from_numpy`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.device import DeviceLike
from voxtral_tpu_torch.loaders import names as N
from voxtral_tpu_torch.loaders.gguf import GGML_Q4_0, GgufReader
from voxtral_tpu_torch.ops.q4 import dequantize_q4_0, repack_q4_0

Params = dict[str, Any]

WEIGHT_FORMATS = ("q4", "q4g", "w8")


class Q4ModelLoader:
    """Loads GGUF Q4_0 checkpoints.

    weight_format:
      * "q4" — keep int4, nibble-packed where K3 takes the shape (the
        per-op decode step, K3 on every decoder linear and the lm_head);
      * "q4g" — keep the unpacked group-32 form ({codes = nibble - 8,
        f16 block scales}, the exact re-encoding of Q4_0), so decode
        runs K1 mode (h) with Q4_0's own weights;
      * "w8" — requantize to rowwise int8 at load (the w8 route, K1
        (a)-(c) and K2), a second, lossy quantization.
    """

    def __init__(self, reader: GgufReader, cfg: Optional[VoxtralConfig] = None,
                 weight_format: str = "q4"):
        if weight_format not in WEIGHT_FORMATS:
            raise ValueError(f"weight_format must be one of {WEIGHT_FORMATS},"
                             f" got {weight_format!r}")
        self.reader = reader
        self.cfg = cfg or VoxtralConfig.voxtral()
        self.weight_format = weight_format

    @classmethod
    def from_file(cls, path: str | Path, **kw) -> "Q4ModelLoader":
        return cls(GgufReader.from_file(path), **kw)

    # -- primitives ---------------------------------------------------------

    def _weight(self, name: str, transpose: bool = True):
        """Q4_0 -> a q4 (or requantized w8) leaf [out, in]; F32/F16 ->
        dense [in, out] (unless ``transpose`` is False, e.g. the
        embedding table, which stays [vocab, d])."""
        from voxtral_tpu_torch.ops.q4_kernel import pack_codes, transpose_scales
        from voxtral_tpu_torch.ops.w8 import quantize_w8_rowwise

        info = self.reader.tensor_info(name)
        if info is None:
            raise KeyError(f"Tensor '{name}' not found in GGUF")
        if info.dtype == GGML_Q4_0:
            shape = info.torch_shape
            if len(shape) != 2:
                raise ValueError(f"Q4_0 tensor '{name}' must be 2-D, got "
                                 f"{shape}")
            n, k = shape
            raw = np.asarray(self.reader.tensor_data(name))
            if self.weight_format == "w8":
                return quantize_w8_rowwise(
                    dequantize_q4_0(raw, n * k).reshape(n, k))
            q4 = repack_q4_0(raw, shape)
            # q4: shapes K3 takes store only the packed form (the tiny
            # ADA matmuls keep int8 codes).  q4g keeps codes + f16 scales:
            # packing would round the scales to bf16.
            if self.weight_format == "q4" and k % 256 == 0 and n % 128 == 0:
                q4 = {"codes_packed": pack_codes(q4["codes"]),
                      "scales_t": transpose_scales(q4["scales"])}
            return {"q4": q4}
        w = self.reader.tensor_f32(name)
        return np.ascontiguousarray(w.T) if transpose else w

    def _f32(self, name: str) -> np.ndarray:
        return self.reader.tensor_f32(name)

    @staticmethod
    def _stack(leaves: list):
        """Stack per-layer leaves (dense arrays or q4 / w8 dicts)."""
        if isinstance(leaves[0], dict):
            fmt = next(iter(leaves[0]))  # "q4" or "w8"
            return {fmt: {key: np.stack([x[fmt][key] for x in leaves], axis=0)
                          for key in leaves[0][fmt]}}
        return np.stack(leaves, axis=0)

    # -- components ---------------------------------------------------------

    def load_encoder(self) -> Params:
        cfg = self.cfg.audio_encoder
        cv = N.conv_names()
        per: dict[str, list] = {k: [] for k in (
            "attention_norm", "ffn_norm", "wq", "wq_b", "wk", "wv", "wv_b",
            "wo", "wo_b", "w1", "w2", "w2_b", "w3",
        )}
        for i in range(cfg.n_layers):
            nm = N.encoder_layer_names(i)
            per["attention_norm"].append(self._f32(nm["attention_norm"]))
            per["wq"].append(self._weight(nm["wq_weight"]))
            per["wq_b"].append(self._f32(nm["wq_bias"]))
            per["wk"].append(self._weight(nm["wk_weight"]))
            per["wv"].append(self._weight(nm["wv_weight"]))
            per["wv_b"].append(self._f32(nm["wv_bias"]))
            per["wo"].append(self._weight(nm["wo_weight"]))
            per["wo_b"].append(self._f32(nm["wo_bias"]))
            per["ffn_norm"].append(self._f32(nm["ffn_norm"]))
            per["w1"].append(self._weight(nm["w1_weight"]))
            per["w2"].append(self._weight(nm["w2_weight"]))
            per["w2_b"].append(self._f32(nm["w2_bias"]))
            per["w3"].append(self._weight(nm["w3_weight"]))
        s = {k: self._stack(v) for k, v in per.items()}
        return {
            "conv": {
                "conv1": self._f32(cv["conv1_weight"]),
                "conv1_b": self._f32(cv["conv1_bias"]),
                "conv2": self._f32(cv["conv2_weight"]),
                "conv2_b": self._f32(cv["conv2_bias"]),
            },
            "layers": {
                "attention_norm": s["attention_norm"],
                "attention": {k: s[k] for k in ("wq", "wq_b", "wk", "wv",
                                                "wv_b", "wo", "wo_b")},
                "ffn_norm": s["ffn_norm"],
                "ffn": {k: s[k] for k in ("w1", "w2", "w2_b", "w3")},
            },
            "norm": self._f32(N.ENCODER_FINAL_NORM),
        }

    def load_decoder(self) -> Params:
        cfg = self.cfg.language_model
        per: dict[str, list] = {k: [] for k in (
            "ada_w0", "ada_w2", "attention_norm", "ffn_norm",
            "wq", "wk", "wv", "wo", "w1", "w2", "w3",
        )}
        for i in range(cfg.n_layers):
            nm = N.decoder_layer_names(i)
            per["ada_w0"].append(self._weight(nm["ada_norm_down"]))
            per["ada_w2"].append(self._weight(nm["ada_norm_up"]))
            per["attention_norm"].append(self._f32(nm["attention_norm"]))
            per["wq"].append(self._weight(nm["wq_weight"]))
            per["wk"].append(self._weight(nm["wk_weight"]))
            per["wv"].append(self._weight(nm["wv_weight"]))
            per["wo"].append(self._weight(nm["wo_weight"]))
            per["ffn_norm"].append(self._f32(nm["ffn_norm"]))
            per["w1"].append(self._weight(nm["w1_weight"]))
            per["w2"].append(self._weight(nm["w2_weight"]))
            per["w3"].append(self._weight(nm["w3_weight"]))
        s = {k: self._stack(v) for k, v in per.items()}
        return {
            "tok_embeddings": self._weight(N.TOK_EMBEDDINGS, transpose=False),
            "layers": {
                "ada": {"w0": s["ada_w0"], "w2": s["ada_w2"]},
                "attention_norm": s["attention_norm"],
                "attention": {k: s[k] for k in ("wq", "wk", "wv", "wo")},
                "ffn_norm": s["ffn_norm"],
                "ffn": {k: s[k] for k in ("w1", "w2", "w3")},
            },
            "norm": self._f32(N.FINAL_NORM),
        }

    def load_adapter(self) -> Params:
        nm = N.adapter_names()
        return {
            "w1": self._weight(nm["linear1_weight"]),
            "w2": self._weight(nm["linear2_weight"]),
        }

    def load_numpy(self) -> Params:
        """The whole parameter tree, numpy leaves (the JAX loader's
        ``load(to_device=False)``)."""
        return {
            "encoder": self.load_encoder(),
            "decoder": self.load_decoder(),
            "adapter": self.load_adapter(),
        }

    def load(self, device: DeviceLike = None) -> Params:
        """The tree as tensors on ``device`` (``None``: the card)."""
        from voxtral_tpu_torch.convert import params_from_numpy

        return params_from_numpy(self.load_numpy(), device)


def load_q4_model(path: str | Path, cfg: Optional[VoxtralConfig] = None,
                  weight_format: str = "q4", device: DeviceLike = None):
    """GGUF file -> VoxtralModel with q4 / q4g / load-time-w8 weights on
    ``device`` (``None``: the card)."""
    from voxtral_tpu_torch.device import resolve_device
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    device = resolve_device(device)
    loader = Q4ModelLoader.from_file(path, cfg=cfg,
                                     weight_format=weight_format)
    return VoxtralModel(loader.load(device), loader.cfg, device)
