"""SafeTensors weight loading into the port's parameter tree (port of
``voxtral_tpu/loaders/safetensors_loader.py``).

The header is parsed by hand (an 8-byte little-endian length, then
JSON) and the data section is memory-mapped with numpy, as the JAX
loader does.  BF16 tensors are read as their raw 16-bit words and become
``torch.bfloat16`` by a view, so no ``ml_dtypes`` is needed on the way
to the device.

Layout conversions while loading (the JAX loader's, the reference's
``weights.rs:251-263``):

* linear weights: PyTorch ``[out, in]`` -> ``[in, out]`` (transposed);
* conv1d weights stay ``[out, in, k]``;
* per-layer tensors are stacked along a leading layer axis;
* the token table may be cut to ``max_vocab_size`` rows.

:func:`load_voxtral_params` builds each leaf on the device: a tensor is
read from the mapping once, copied to the device, transposed and cast
there, and a stack is filled layer by layer in place, so a 17 GB f32
tree passes through host memory once, a tensor at a time.  With
``to_device=False`` it returns the JAX loader's numpy tree instead (the
input of the w8 requantization, which runs on the host).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.device import DeviceLike, resolve_device
from voxtral_tpu_torch.loaders import names as N

Params = dict[str, Any]

# SafeTensors dtype -> the numpy dtype its bytes are read as (BF16: the
# raw words, viewed as torch.bfloat16 afterwards).
_RAW = {
    "F64": np.dtype(np.float64),
    "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "BF16": np.dtype(np.uint16),
    "I64": np.dtype(np.int64),
    "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "BOOL": np.dtype(np.bool_),
}

_TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SafeTensorsFile:
    """Read-only memory-mapped SafeTensors file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(header_len))
        header.pop("__metadata__", None)
        self._index = header
        self._data_offset = 8 + header_len
        self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")

    def names(self) -> list[str]:
        return list(self._index.keys())

    def has_tensor(self, name: str) -> bool:
        return name in self._index

    def tensor_meta(self, name: str) -> tuple[str, tuple[int, ...]]:
        info = self._index[name]
        return info["dtype"], tuple(info["shape"])

    def raw(self, name: str, rows: Optional[int] = None) -> np.ndarray:
        """One tensor's bytes as a numpy view of the mapping (BF16 as
        uint16 words); ``rows``: only the leading rows."""
        if name not in self._index:
            raise KeyError(f"Tensor '{name}' not found in {self.path}")
        info = self._index[name]
        dt = _RAW.get(info["dtype"])
        if dt is None:
            raise ValueError(
                f"Unsupported SafeTensors dtype {info['dtype']!r}")
        shape = list(info["shape"])
        start, end = info["data_offsets"]
        if rows is not None and shape and rows < shape[0]:
            end = start + (end - start) // shape[0] * rows
            shape[0] = rows
        raw = self._mmap[self._data_offset + start:self._data_offset + end]
        return raw.view(dt).reshape(shape)

    def tensor_torch(self, name: str, dtype: torch.dtype, device,
                     rows: Optional[int] = None) -> torch.Tensor:
        """One tensor on ``device`` in ``dtype``: copied off the mapping
        once, cast on the device (f32 -> bf16 rounds to nearest even, as
        ml_dtypes' astype in the JAX loader)."""
        info_dtype = self._index[name]["dtype"]
        t = torch.from_numpy(np.array(self.raw(name, rows)))
        if info_dtype == "BF16":
            t = t.view(torch.bfloat16)
        return t.to(device).to(dtype)

    def tensor(self, name: str, dtype: Optional[np.dtype] = None) -> np.ndarray:
        """One tensor as numpy (the JAX loader's ``tensor``): a view of the
        mapping unless a conversion is asked for; BF16 as ml_dtypes'
        bfloat16."""
        arr = self.raw(name)
        if self._index[name]["dtype"] == "BF16":
            import ml_dtypes

            arr = arr.view(ml_dtypes.bfloat16)
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        return arr


class _DeviceLeaves:
    """Leaves as tensors on a device: each read once from the mapping,
    transposed and cast there; stacks filled layer by layer."""

    def __init__(self, st: SafeTensorsFile, dtype: torch.dtype, device):
        self.st, self.dtype, self.device = st, dtype, device

    def one(self, name: str, linear: bool = False,
            rows: Optional[int] = None) -> torch.Tensor:
        t = self.st.tensor_torch(name, self.dtype, self.device, rows)
        return t.T.contiguous() if linear else t

    def stack(self, names: list, linear: bool = False) -> torch.Tensor:
        first = self.one(names[0], linear)
        out = torch.empty((len(names), *first.shape), dtype=self.dtype,
                          device=self.device)
        out[0] = first
        del first
        for i, name in enumerate(names[1:], 1):
            t = self.st.tensor_torch(name, self.dtype, self.device)
            out[i] = t.T if linear else t
        return out


class _NumpyLeaves:
    """The JAX loader's numpy leaves (``to_device=False``)."""

    def __init__(self, st: SafeTensorsFile, dtype: np.dtype):
        self.st, self.dtype = st, dtype

    def one(self, name: str, linear: bool = False,
            rows: Optional[int] = None) -> np.ndarray:
        arr = self.st.tensor(name, self.dtype)
        if rows is not None and arr.shape[0] > rows:
            arr = arr[:rows]
        return np.ascontiguousarray(arr.T) if linear else arr

    def stack(self, names: list, linear: bool = False) -> np.ndarray:
        return np.stack([self.one(n, linear) for n in names], axis=0)


def load_encoder_params(leaves, cfg: VoxtralConfig) -> Params:
    cv = N.conv_names()
    L = cfg.audio_encoder.n_layers
    nm = [N.encoder_layer_names(i) for i in range(L)]

    def stack(key, linear=False):
        return leaves.stack([n[key] for n in nm], linear)

    return {
        "conv": {
            "conv1": leaves.one(cv["conv1_weight"]),
            "conv1_b": leaves.one(cv["conv1_bias"]),
            "conv2": leaves.one(cv["conv2_weight"]),
            "conv2_b": leaves.one(cv["conv2_bias"]),
        },
        "norm": leaves.one(N.ENCODER_FINAL_NORM),
        "layers": {
            "attention_norm": stack("attention_norm"),
            "attention": {
                "wq": stack("wq_weight", True), "wq_b": stack("wq_bias"),
                "wk": stack("wk_weight", True),
                "wv": stack("wv_weight", True), "wv_b": stack("wv_bias"),
                "wo": stack("wo_weight", True), "wo_b": stack("wo_bias"),
            },
            "ffn_norm": stack("ffn_norm"),
            "ffn": {
                "w1": stack("w1_weight", True),
                "w2": stack("w2_weight", True), "w2_b": stack("w2_bias"),
                "w3": stack("w3_weight", True),
            },
        },
    }


def load_decoder_params(leaves, cfg: VoxtralConfig,
                        max_vocab_size: Optional[int] = None) -> Params:
    L = cfg.language_model.n_layers
    nm = [N.decoder_layer_names(i) for i in range(L)]

    def stack(key, linear=False):
        return leaves.stack([n[key] for n in nm], linear)

    # Vocab truncation (reference loader.rs:205-218): only the leading
    # rows are read.
    return {
        "tok_embeddings": leaves.one(N.TOK_EMBEDDINGS, rows=max_vocab_size),
        "layers": {
            # ada_norm_down [t_cond, d] -> w0 [d, t_cond]; ada_norm_up
            # [d, t_cond] -> w2 [t_cond, d] (decoder_layer.rs:108-133).
            "ada": {"w0": stack("ada_norm_down", True),
                    "w2": stack("ada_norm_up", True)},
            "attention_norm": stack("attention_norm"),
            "attention": {
                "wq": stack("wq_weight", True), "wk": stack("wk_weight", True),
                "wv": stack("wv_weight", True), "wo": stack("wo_weight", True),
            },
            "ffn_norm": stack("ffn_norm"),
            "ffn": {
                "w1": stack("w1_weight", True), "w2": stack("w2_weight", True),
                "w3": stack("w3_weight", True),
            },
        },
        "norm": leaves.one(N.FINAL_NORM),
    }


def load_adapter_params(leaves) -> Params:
    nm = N.adapter_names()
    return {
        "w1": leaves.one(nm["linear1_weight"], True),
        "w2": leaves.one(nm["linear2_weight"], True),
    }


def load_voxtral_params(
    path: str | Path,
    cfg: Optional[VoxtralConfig] = None,
    dtype: str = "bfloat16",
    max_vocab_size: Optional[int] = None,
    device: DeviceLike = None,
    to_device: bool = True,
) -> Params:
    """The full parameter tree from ``consolidated.safetensors``.

    ``dtype``: "bfloat16" or "float32".  Tensors on ``device`` (``None``:
    the card), or the JAX loader's numpy tree with ``to_device=False``.
    """
    if dtype not in _TORCH:
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
    cfg = cfg or VoxtralConfig.voxtral()
    st = SafeTensorsFile(path)
    if to_device:
        leaves = _DeviceLeaves(st, _TORCH[dtype], resolve_device(device))
    else:
        if dtype == "bfloat16":
            import ml_dtypes

            np_dtype = np.dtype(ml_dtypes.bfloat16)
        else:
            np_dtype = np.dtype(np.float32)
        leaves = _NumpyLeaves(st, np_dtype)
    return {
        "encoder": load_encoder_params(leaves, cfg),
        "decoder": load_decoder_params(leaves, cfg, max_vocab_size),
        "adapter": load_adapter_params(leaves),
    }


def checkpoint_tensors(params: Params, cfg: VoxtralConfig) -> dict:
    """The inverse of :func:`load_voxtral_params`: a dense tree (numpy
    arrays or tensors) -> ``{checkpoint name: array}`` in the
    checkpoint's layout (linears [out, in], one tensor per layer), for
    :func:`save_safetensors`."""

    def lin(a):
        return a.T

    out = {}
    enc, dec = params["encoder"], params["decoder"]
    cv = N.conv_names()
    for key in ("conv1", "conv2"):
        out[cv[f"{key}_weight"]] = enc["conv"][key]
        out[cv[f"{key}_bias"]] = enc["conv"][f"{key}_b"]
    out[N.ENCODER_FINAL_NORM] = enc["norm"]
    lyr = enc["layers"]
    att, ffn = lyr["attention"], lyr["ffn"]
    for i in range(cfg.audio_encoder.n_layers):
        nm = N.encoder_layer_names(i)
        out[nm["attention_norm"]] = lyr["attention_norm"][i]
        out[nm["ffn_norm"]] = lyr["ffn_norm"][i]
        for key in ("wq", "wk", "wv", "wo"):
            out[nm[f"{key}_weight"]] = lin(att[key][i])
        for key in ("wq", "wv", "wo"):
            out[nm[f"{key}_bias"]] = att[f"{key}_b"][i]
        for key in ("w1", "w2", "w3"):
            out[nm[f"{key}_weight"]] = lin(ffn[key][i])
        out[nm["w2_bias"]] = ffn["w2_b"][i]
    out[N.TOK_EMBEDDINGS] = dec["tok_embeddings"]
    out[N.FINAL_NORM] = dec["norm"]
    lyr = dec["layers"]
    att, ffn = lyr["attention"], lyr["ffn"]
    for i in range(cfg.language_model.n_layers):
        nm = N.decoder_layer_names(i)
        out[nm["ada_norm_down"]] = lin(lyr["ada"]["w0"][i])
        out[nm["ada_norm_up"]] = lin(lyr["ada"]["w2"][i])
        out[nm["attention_norm"]] = lyr["attention_norm"][i]
        out[nm["ffn_norm"]] = lyr["ffn_norm"][i]
        for key in ("wq", "wk", "wv", "wo"):
            out[nm[f"{key}_weight"]] = lin(att[key][i])
        for key in ("w1", "w2", "w3"):
            out[nm[f"{key}_weight"]] = lin(ffn[key][i])
    an = N.adapter_names()
    out[an["linear1_weight"]] = lin(params["adapter"]["w1"])
    out[an["linear2_weight"]] = lin(params["adapter"]["w2"])
    return out


def save_safetensors(tensors: dict, path: str | Path) -> None:
    """Write ``{name: array}`` as a SafeTensors file (numpy arrays: f32,
    f16, ml_dtypes bf16, ints; or tensors, bf16 included), in the layout
    :class:`SafeTensorsFile` reads: the tests and the card's smoke run
    write their small checkpoints with it."""
    codes = {"float64": "F64", "float32": "F32", "float16": "F16",
             "bfloat16": "BF16", "int64": "I64", "int32": "I32",
             "int16": "I16", "int8": "I8", "uint8": "U8", "bool": "BOOL"}
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            t = arr.detach().cpu().contiguous()
            kind = str(t.dtype).removeprefix("torch.")
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            data = t.numpy().tobytes()
            shape = list(arr.shape)
        else:
            a = np.ascontiguousarray(arr)
            kind, data, shape = a.dtype.name, a.tobytes(), list(a.shape)
        header[name] = {"dtype": codes[kind], "shape": shape,
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
