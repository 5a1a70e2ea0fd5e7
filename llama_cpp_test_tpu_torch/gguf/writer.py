"""GGUF v3 file writer. Counterpart of llama_cpp_test_tpu/gguf/writer.py.

Float tensors are written as F32/F16/BF16; quantized tensors are passed in
as already-packed block bytes (chip_smoke.py synthesizes those from seeded
random bytes). This port carries no quantizer.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Sequence

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    type_size,
)

_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_VT = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, (bool, np.bool_)):
        return GGUFValueType.BOOL
    if isinstance(value, (int, np.integer)):
        v = int(value)
        if v < 0:
            return GGUFValueType.INT32 if v >= -(2**31) else GGUFValueType.INT64
        return GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(value, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot map {type(value)} to a GGUF value type")


class GGUFWriter:
    def __init__(self, path: str, arch: str | None = None,
                 alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        # (name, shape ggml-order, type, packed bytes)
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []
        if arch is not None:
            self.add_kv("general.architecture", arch)
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add_kv("general.alignment", np.uint32(alignment))

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        if vtype is None:
            vtype = _infer_vtype(value)
        # last write wins: duplicate keys make a file unreadable elsewhere
        self._kv = [(k, t, v) for (k, t, v) in self._kv if k != key]
        self._kv.append((key, vtype, value))

    def add_tensor(self, name: str, array: np.ndarray,
                   ggml_type: GGMLType | None = None,
                   raw_ggml_shape: Sequence[int] | None = None) -> None:
        """Add a tensor. `array` is in numpy (row-major) order; the stored
        ggml shape is the reverse. Packed quantized bytes (uint8) need
        raw_ggml_shape + ggml_type."""
        if array.dtype == np.uint8 and ggml_type is not None and raw_ggml_shape is not None:
            shape = tuple(int(d) for d in raw_ggml_shape)
            packed = np.ascontiguousarray(array.reshape(-1))
            expect = type_size(ggml_type, int(np.prod(shape)))
            if packed.nbytes != expect:
                raise ValueError(f"{name}: packed size {packed.nbytes} != expected {expect}")
            self._tensors.append((name, shape, ggml_type, packed))
            return
        ggml_shape = tuple(reversed(array.shape))
        if ggml_type is None:
            ggml_type = GGMLType.F32
        if ggml_type in (GGMLType.F32, GGMLType.F16):
            np_dt = np.float32 if ggml_type == GGMLType.F32 else np.float16
            packed = np.ascontiguousarray(array.astype(np_dt)).view(np.uint8).reshape(-1)
        elif ggml_type == GGMLType.BF16:
            f32 = np.ascontiguousarray(array.astype(np.float32))
            packed = (f32.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8).reshape(-1)
        else:
            raise NotImplementedError(
                f"{name}: this writer takes {ggml_type.name} only as packed "
                "block bytes (uint8 + raw_ggml_shape)")
        self._tensors.append((name, ggml_shape, ggml_type, packed))

    def _write_str(self, f: BinaryIO, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f: BinaryIO, vtype: GGUFValueType, value: Any) -> None:
        if vtype == GGUFValueType.STRING:
            self._write_str(f, value)
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray) and value.dtype != object:
                itype = (GGUFValueType.BOOL if value.dtype == np.bool_
                         else _NP_TO_VT[value.dtype])
                f.write(struct.pack("<IQ", int(itype), value.size))
                if itype == GGUFValueType.BOOL:
                    f.write(value.astype(np.uint8).tobytes())
                else:
                    f.write(np.ascontiguousarray(value).tobytes())
            else:
                items = list(value)
                itype = _infer_vtype(items[0]) if items else GGUFValueType.STRING
                if itype in (GGUFValueType.UINT32, GGUFValueType.INT32) and items:
                    if any(int(i) < 0 for i in items):
                        itype = GGUFValueType.INT32
                f.write(struct.pack("<IQ", int(itype), len(items)))
                for it in items:
                    self._write_value(f, itype, it)
        else:
            f.write(struct.pack(_SCALAR_PACK[vtype], value))

    def write(self) -> None:
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<IQQ", GGUF_VERSION, len(self._tensors), len(self._kv)))
            for key, vtype, value in self._kv:
                self._write_str(f, key)
                f.write(struct.pack("<I", int(vtype)))
                self._write_value(f, vtype, value)
            offset = 0
            for name, shape, ttype, packed in self._tensors:
                self._write_str(f, name)
                f.write(struct.pack("<I", len(shape)))
                for d in shape:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", int(ttype), offset))
                offset += packed.nbytes
                offset += -offset % self.alignment
            pad = -f.tell() % self.alignment
            f.write(b"\x00" * pad)
            for _, _, _, packed in self._tensors:
                f.write(memoryview(packed))    # no copy of the bytes
                f.write(b"\x00" * (-packed.nbytes % self.alignment))
