"""Quantized parameter containers and absmax quantizers
(``repro/quant/tensor.py``).

Weight-only post-training quantization: a post-load transform
(:func:`repro_torch.quant.params.quantize_params`) wraps the matmul weights
in :class:`QuantTensor` containers, storage codes plus float16 absmax scales.
The MLP's ``dense`` sends a ``QuantTensor`` to the ``gemm_wq`` kernel, which
reads the codes at storage width; the attention projections and the tied LM
head dequantize and multiply, as the reference does.

Calibration is plain symmetric absmax, with the reference's rules kept
exactly (``tests/test_torch_quant.py`` holds the codes and scales bit for
bit against ``repro.quant``):

  * int8: ``scale = amax / 127``, values rounded half to even and clipped
    to [-127, 127];
  * fp8-e4m3 (``torch.float8_e4m3fn``): ``scale = amax / 448``, values
    clipped to [-448, 448] *before* the cast (the raw cast does not
    saturate past the largest finite value);
  * int4: ``scale = amax / 7``, values rounded and clipped to [-7, 7], then
    packed two per int8 byte along the quantization axis, the low nibble
    holding the even logical index.

Absmax is floored at ``_EPS`` so an all-zero row or block quantizes to
exact zeros instead of a 0.0 float16 scale and NaN codes.
"""
from __future__ import annotations

import torch

#: storage dtypes, with the reference's accepted aliases
QUANT_DTYPES = ("int8", "float8_e4m3fn", "int4")
_ALIASES = {"fp8": "float8_e4m3fn", "e4m3": "float8_e4m3fn",
            "float8": "float8_e4m3fn", "int8": "int8",
            "float8_e4m3fn": "float8_e4m3fn", "int4": "int4"}
#: largest code magnitude per storage dtype
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0, "int4": 7.0}
#: absmax floor: 1e-4 / 448 is still a float16 subnormal, so the scale of
#: an all-zero row survives the cast
_EPS = 1e-4
SCALE_DTYPE = torch.float16


def canonical_dtype(name: str) -> str:
    """Normalize a quant dtype alias (``"fp8"`` -> ``"float8_e4m3fn"``)."""
    if name not in _ALIASES:
        raise ValueError(f"unknown quant dtype {name!r}; expected one of "
                         f"{sorted(set(_ALIASES))}")
    return _ALIASES[name]


def is_quant_dtype(name: str) -> bool:
    return bool(name) and name in _ALIASES


def storage_dtype(name: str) -> torch.dtype:
    """Torch dtype of the stored codes (int4 lives two per int8 byte)."""
    name = canonical_dtype(name)
    return torch.int8 if name in ("int8", "int4") else torch.float8_e4m3fn


def dtype_bytes(name: str) -> float:
    """Storage bytes per logical element (packed int4 is half a byte)."""
    if is_quant_dtype(name):
        name = canonical_dtype(name)
        if name == "int4":
            return 0.5
        return storage_dtype(name).itemsize
    return getattr(torch, name).itemsize


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor viewed as uint8 (other dtypes as they are), so that
    indexing and scatters run on any torch build; ``.view`` back after."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _cast_q(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """float32 scaled values -> storage codes (unpacked for int4)."""
    if dtype in ("int8", "int4"):
        q = _QMAX[dtype]
        return torch.clamp(torch.round(x), -q, q).to(torch.int8)
    return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn)


# --------------------------------------------------------------------------
# int4 nibble packing
# --------------------------------------------------------------------------
def pack_int4(codes: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int8 codes in [-7, 7] two per byte along ``axis`` (even
    length): byte ``i`` holds element ``2i`` in its low nibble and ``2i+1``
    in its high nibble."""
    axis = axis % codes.dim()
    K = codes.shape[axis]
    if K % 2:
        raise ValueError(f"int4 packing needs an even axis length, got {K}")
    c = codes.to(torch.int8).unflatten(axis, (K // 2, 2))
    lo, hi = c.select(axis + 1, 0), c.select(axis + 1, 1)
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(packed: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``axis`` doubles; nibbles are
    sign-extended by a shift pair (arithmetic ``>>`` on int8)."""
    axis = axis % packed.dim()
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], dim=axis + 1).flatten(axis, axis + 1)


# --------------------------------------------------------------------------
# weights: per-channel or per-block scales along a contraction axis
# --------------------------------------------------------------------------
def quantize_weight(w: torch.Tensor, dtype: str = "int8", *, block: int = 0,
                    axis: int = -2) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` along ``axis``. Returns ``(q, scales)``: ``q`` has
    ``w``'s shape in the storage dtype (int4: ``axis`` packed to half
    length), ``scales`` float16 with ``axis`` reduced to ``K // block``
    blocks (1 when ``block`` is 0 or does not divide the axis)."""
    dtype = canonical_dtype(dtype)
    axis = axis % w.dim()
    K = w.shape[axis]
    nb = K // block if block and K % block == 0 else 1
    wb = w.float().unflatten(axis, (nb, K // nb))
    amax = torch.clamp_min(wb.abs().amax(dim=axis + 1), _EPS)
    scales = (amax / _QMAX[dtype]).to(SCALE_DTYPE)
    q = _cast_q(wb / scales.float().unsqueeze(axis + 1), dtype)
    q = q.flatten(axis, axis + 1)
    if dtype == "int4":
        q = pack_int4(q, axis)
    return q, scales


def dequantize_weight(q: torch.Tensor, scales: torch.Tensor, *,
                      axis: int = -2, dtype: torch.dtype = torch.float32,
                      pack: int = 1) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`, computed in float32 and cast to
    ``dtype``; ``pack=2`` unpacks int4 nibbles along ``axis`` first."""
    axis = axis % q.dim()
    if pack == 2:
        q = unpack_int4(q, axis)
    nb = scales.shape[axis]
    out = q.float().unflatten(axis, (nb, q.shape[axis] // nb)) \
        * scales.float().unsqueeze(axis + 1)
    return out.flatten(axis, axis + 1).to(dtype)


# --------------------------------------------------------------------------
# KV rows: one scale per written row per head
# --------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor, dtype: str = "int8"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) float K/V rows -> (codes (..., hd), scales (...)
    float16). int4 is weight-only: pool rows stay byte-addressable."""
    dtype = canonical_dtype(dtype)
    if dtype == "int4":
        raise ValueError("int4 is weight-only; KV pools support int8/fp8")
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=-1), _EPS)
    scales = (amax / _QMAX[dtype]).to(SCALE_DTYPE)
    return _cast_q(xf / scales.float()[..., None], dtype), scales


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: (..., hd) codes, (...) scales."""
    return (q.float() * scales.float()[..., None]).to(dtype)


# --------------------------------------------------------------------------
# the container
# --------------------------------------------------------------------------
class QuantTensor:
    """A weight-only quantized parameter: storage codes ``q`` and float16
    absmax ``scales``.

    ``axis`` (counted from the end) is the axis the scales reduce: -2 for
    ``(K, N)`` matmul kernels, -1 for the per-row embedding table. ``pack``
    is 1 for byte-addressable codes and 2 for int4 nibbles, where ``q``'s
    ``axis`` is physically half the logical length; ``shape`` reports the
    logical shape. Indexing slices the leading (stacked layer or row) axis
    of codes and scales together.
    """

    def __init__(self, q: torch.Tensor, scales: torch.Tensor, axis: int = -2,
                 pack: int = 1):
        if axis >= 0:
            raise ValueError("axis counts from the end (-1 or -2)")
        self.q, self.scales, self.axis, self.pack = q, scales, axis, pack

    @property
    def shape(self) -> torch.Size:
        s = list(self.q.shape)
        s[self.axis] *= self.pack
        return torch.Size(s)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """Physical storage bytes, codes plus scales."""
        return (self.q.numel() * self.q.element_size()
                + self.scales.numel() * self.scales.element_size())

    def __getitem__(self, idx) -> "QuantTensor":
        if self.ndim + self.axis < 1:
            raise IndexError("indexing would cut the quantization axis")
        return QuantTensor(self.q[idx], self.scales[idx], self.axis,
                           self.pack)

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.q.to(device), self.scales.to(device),
                           self.axis, self.pack)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return dequantize_weight(self.q, self.scales, axis=self.axis,
                                 dtype=dtype, pack=self.pack)

    def take_rows(self, idx: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Gather leading-axis rows and dequantize only those (the
        embedding lookup); needs per-row scales (``axis == -1``)."""
        if self.axis != -1:
            raise ValueError("take_rows needs per-row scales (axis=-1)")
        q = as_bytes(self.q)[idx].view(self.q.dtype)
        return dequantize_weight(q, self.scales[idx], axis=-1, dtype=dtype,
                                 pack=self.pack)

    def __repr__(self) -> str:
        return (f"QuantTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"n_blocks={self.scales.shape[self.axis]}, axis={self.axis}, "
                f"pack={self.pack})")


def quantize_tensor(w: torch.Tensor, dtype: str = "int8", *, block: int = 0,
                    axis: int = -2) -> QuantTensor:
    q, scales = quantize_weight(w, dtype, block=block, axis=axis)
    pack = 2 if canonical_dtype(dtype) == "int4" else 1
    return QuantTensor(q, scales, axis=axis if axis < 0 else axis - w.dim(),
                       pack=pack)
