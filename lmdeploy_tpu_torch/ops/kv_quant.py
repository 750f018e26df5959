"""Per-token KV-cache quantization: int8 (quant_policy 4), int4 (8), fp8 (16) and
TurboQuant k4v2 (42).

Port of ``lmdeploy_tpu/ops/kv_quant.py``: each token's K and V vector gets its
quantization parameters per kv head, computed online when the cache is filled; there
is no calibration.  The port keeps its own page layouts (each lossless to the
reference's through ``weight_convert``), chosen so that every token owns its bytes:
the fill is one ``index_copy_`` per tensor, and a decode kernel loads one head's slice
of a page with 16-byte loads.

  * int8 ``QuantKV``: ``data`` int8 ``[L, NB, 2, BS, Hkv*D]`` (K and V planes of
    head-major rows; the reference layout without its 128-lane row padding, the
    reference's ``QuantKV`` docstring is stale), ``scale`` f32 ``[L, NB, 2, BS, Hkv]``
    token-major.
  * int4 ``QuantKV4``: ``data`` u8 ``[L, NB, 2, BS, Hkv*D/2]``, byte j of a token's
    head-major row holding dim 2j in its low nibble and dim 2j+1 in its high one;
    ``scale`` and ``minv`` f32 ``[L, NB, 2, BS, Hkv]`` token-major.  The reference packs
    token PAIRS into one byte row and keeps head-major de-interleaved scales
    (``deint_scale_pos``), because Mosaic pads a ``[*, HD/2]`` array back to full
    width; that costs its fill a read-merge-write per parity.
  * fp8: the plain cache's layout in ``torch.float8_e4m3fn`` (``to_fp8`` casts).
  * TurboQuant ``QuantKVTurbo``: ``data`` u8 ``[L, NB, BS, 3*Hkv*D/4]``, one row per
    token: the K codes (bytes ``[0, Hkv*D/2)``, head h at ``h*D/2``, two 4-bit codes a
    byte as int4's) then the V codes (bytes ``[Hkv*D/2, 3*Hkv*D/4)``, head h at
    ``Hkv*D/2 + h*D/4``, four 2-bit codes a byte, dim 4j+e at bits 2e..2e+1); ``meta``
    f32 ``[L, NB, BS, 3, Hkv]``: (K mse norm, K qjl norm, V norm).  The reference packs
    over the whole head-major row (byte j holds P[j] and P[j + Hkv*D/2], pairing head h
    with head h + Hkv/2) and keeps V two codes a byte at K's width; the port's V takes
    a quarter of a byte per dim, so a token is ``Hkv*(3*D/4 + 12)`` bytes.

Every quantized cache's ``.shape`` is the LOGICAL ``[L, NB, 2, BS, Hkv*D]``: the model
reads the block size from ``shape[3]`` (the reference's int4 cache once leaked its
packed pair dim there and scrambled every fill).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def f32_reciprocal(c: float) -> float:
    """``fl(1/c)`` in f32, as a Python float (exact in f32 again).  The reference's
    quantizers run inside jitted steps, where XLA rewrites ``x / c`` for a constant
    ``c`` into ``x * fl(1/c)``; a product by this value gives that on every device."""
    return float(np.float32(1.0) / np.float32(c))


def scale_plus_eps(x: torch.Tensor, c: float, eps: float) -> torch.Tensor:
    """``fl(x * c + eps)`` with one rounding, f32: the jitted reference's ``x / k + eps``
    after XLA's rewrite, whose CPU backend contracts the product and the add into one
    fused multiply-add.  In f64 the product of two f32 values is exact and the sum
    rounds once before the f32 rounding; that second rounding can differ from a fused
    one only where the f64 sum lies on an f32 tie, within 2^-53 of it."""
    return (x.double() * c + float(np.float32(eps))).float()


class _QuantCache:
    """A paged cache of several tensors that share the leading ``[L, NB]`` dims;
    ``.dtype`` / ``.device`` proxy to the code pages, ``.shape`` is the logical one."""

    _fields: Tuple[str, ...] = ()

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in self._fields)

    def clone(self):
        return type(self)(*(t.clone() for t in self.tensors()))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


class QuantKV(_QuantCache):
    """An int8 paged cache: ``data`` pages plus per-(token, head) ``scale`` pages."""

    _fields = ('data', 'scale')

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape


class QuantKV4(_QuantCache):
    """An int4 paged cache: nibble-packed ``data`` plus per-(token, head) ``scale`` and
    ``minv``; x = q * scale + minv with q in 0..15."""

    _fields = ('data', 'scale', 'minv')

    def __init__(self, data: torch.Tensor, scale: torch.Tensor, minv: torch.Tensor):
        self.data = data
        self.scale = scale
        self.minv = minv

    @property
    def shape(self):
        d = self.data.shape
        return torch.Size(tuple(d[:4]) + (d[4] * 2,))


class QuantKVTurbo(_QuantCache):
    """A TurboQuant k4v2 paged cache: per-token rows of K and V codes plus per-token
    ``meta`` (K mse norm, K qjl norm, V norm) per head.  Rows live in the
    Hadamard-rotated domain."""

    _fields = ('data', 'meta')

    def __init__(self, data: torch.Tensor, meta: torch.Tensor):
        self.data = data
        self.meta = meta

    @property
    def shape(self):
        L, NB, BS, row = self.data.shape
        return torch.Size((L, NB, 2, BS, row * 4 // 3))


_INV127 = f32_reciprocal(127.0)
_INV15 = f32_reciprocal(15.0)


def quantize_rows(x: torch.Tensor, eps: float = 1e-8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]): absmax/127 + eps per row as the
    jitted reference computes it (``scale_plus_eps``), round half to even
    (``torch.round``, as ``jnp.round``), clipped to +-127."""
    xf = x.float()
    scale = scale_plus_eps(xf.abs().amax(dim=-1), _INV127, eps)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize(data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [..., D] * f32 [...] -> f32 [..., D]."""
    return data.float() * scale[..., None]


# ---------------------------------------------------------------------------- int4 --
def deint_scale_pos(slot, block_size: int):
    """Token slot -> position in the reference's de-interleaved per-page scale vector
    ([even slots | odd slots]); ``weight_convert`` uses it."""
    return (slot % 2) * (block_size // 2) + slot // 2


def quantize_rows_int4(x: torch.Tensor, eps: float = 1e-8
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., D] -> (u8 values 0..15 [..., D], f32 scale [...], f32 minv [...]):
    per-row asymmetric min/max, scale = (max - min) / 15 + eps as the jitted reference
    computes it (``scale_plus_eps``), round half to even."""
    xf = x.float()
    mn = xf.amin(dim=-1)
    mx = xf.amax(dim=-1)
    scale = scale_plus_eps(mx - mn, _INV15, eps)
    q = torch.clamp(torch.round((xf - mn[..., None]) / scale[..., None]), 0, 15)
    return q.to(torch.uint8), scale, mn


def dequantize_int4(q: torch.Tensor, scale: torch.Tensor, minv: torch.Tensor
                    ) -> torch.Tensor:
    return q.float() * scale[..., None] + minv[..., None]


def pack_nibbles(x: torch.Tensor) -> torch.Tensor:
    """u8 values 0..15 [..., 2n] -> [..., n]: byte j = x[2j] | x[2j+1] << 4."""
    return x[..., 0::2] | (x[..., 1::2] << 4)


def unpack_nibbles(b: torch.Tensor) -> torch.Tensor:
    """[..., n] -> u8 values 0..15 [..., 2n] (inverse of ``pack_nibbles``)."""
    return torch.stack([b & 0xF, b >> 4], dim=-1).flatten(-2)


def pack_2bit(x: torch.Tensor) -> torch.Tensor:
    """u8 values 0..3 [..., 4n] -> [..., n]: byte j holds x[4j+e] at bits 2e..2e+1."""
    return x[..., 0::4] | (x[..., 1::4] << 2) | (x[..., 2::4] << 4) | (x[..., 3::4] << 6)


def unpack_2bit(b: torch.Tensor) -> torch.Tensor:
    """[..., n] -> u8 values 0..3 [..., 4n] (inverse of ``pack_2bit``)."""
    return torch.stack([(b >> s) & 0x3 for s in (0, 2, 4, 6)], dim=-1).flatten(-2)


# ----------------------------------------------------------------------------- fp8 --
# JAX (ml_dtypes) casts |x| > 464 -- the midpoint past e4m3's largest value 448,
# infinities included -- to NaN, keeping the sign bit; torch saturates them to +-448.
# In range the two agree bit for bit.  The port keeps the reference's NaN.
FP8_OVERFLOW = 464.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x -> e4m3 bytes (u8, as the reference's ``astype(float8_e4m3fn)`` gives them):
    NaN (0x7F with x's sign bit) past the range and for a NaN x."""
    b = x.to(torch.float8_e4m3fn).view(torch.uint8)
    xf = x.float()
    nan = (xf.abs() > FP8_OVERFLOW) | torch.isnan(xf)
    return torch.where(nan, torch.signbit(xf).to(torch.uint8) << 7 | 0x7F, b)


# ---------------------------------------------------------------------- TurboQuant --
# Both K and V rows are Hadamard-rotated per head when the cache is filled, then
# coded per (token, head) row on the normalized row (coordinates ~ N(0, 1/D)):
#   K: 3-bit Lloyd-Max index | the residual's sign bit << 3; meta (mse_norm, qjl_norm)
#      k ~= mse_norm * (centroid[idx] + qjl_norm * sign)
#   V: 2-bit Lloyd-Max index; meta norm:  v ~= norm * centroid2[code]
# Lloyd-Max codebooks at sigma = 1 (the reference's), scaled by 1/sqrt(D) at use.
LLOYD_C3 = np.array([-2.1519456, -1.3439093, -0.7560052, -0.2450942,
                     0.2450942, 0.7560052, 1.3439093, 2.1519456], np.float32)
LLOYD_B3 = np.array([-1.7479274, -1.0499573, -0.5005497, 0.0,
                     0.5005497, 1.0499573, 1.7479274], np.float32)
LLOYD_C2 = np.array([-1.5104176, -0.4527808, 0.4527808, 1.5104176], np.float32)
LLOYD_B2 = np.array([-0.9815992, 0.0, 0.9815992], np.float32)

_HADAMARD: Dict[Tuple[int, str], torch.Tensor] = {}
_CODEBOOKS: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}
_BOUNDARIES: Dict[Tuple[bytes, str], torch.Tensor] = {}


def _device_table(a: np.ndarray, device) -> torch.Tensor:
    """A constant host table copied to ``device`` once.  Never during a CUDA graph
    capture, where a copy from pageable memory is illegal: ``turbo_tables`` makes
    them ahead."""
    if torch.device(device).type == 'cuda' and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('a TurboQuant table is made during a CUDA graph capture: '
                           'call kv_quant.turbo_tables first')
    return torch.from_numpy(a).to(device)


def turbo_tables(d: int, device):
    """Make every TurboQuant table of head dim ``d`` on ``device`` (the Hadamard
    matrix, the codebooks and the Lloyd boundaries) before any capture reads them."""
    hadamard(d, device)
    turbo_codebooks(d, device)
    for boundaries in (LLOYD_B3, LLOYD_B2):
        _boundaries(boundaries * turbo_sigma(d), device)


def turbo_sigma(d: int) -> np.float32:
    """The codebooks' scale 1/sqrt(d), rounded to f32 as the reference rounds it."""
    return np.float32(1.0 / np.sqrt(d))


def hadamard(d: int, device='cpu') -> torch.Tensor:
    """Normalized Walsh-Hadamard matrix Q = H / sqrt(d), f32 [d, d] (orthogonal and
    symmetric); d must be a power of 2."""
    key = (d, str(device))
    if key not in _HADAMARD:
        assert d & (d - 1) == 0, f'head_dim {d} not a power of 2'
        H = np.array([[1.0]], np.float32)
        while H.shape[0] < d:
            H = np.block([[H, H], [H, -H]])
        _HADAMARD[key] = _device_table((H / np.sqrt(d)).astype(np.float32), device)
    return _HADAMARD[key]


def hadamard_rotate(x: torch.Tensor) -> torch.Tensor:
    """Rotate the trailing head_dim axis in f32: y = x @ Q^T (the reference's
    convention).  A plain f32 matrix product: TF32 stays off, PyTorch's default."""
    return torch.matmul(x.float(), hadamard(x.shape[-1], x.device).t())


def hadamard_rotate_inv(x: torch.Tensor) -> torch.Tensor:
    """The inverse rotation in f32: x @ Q."""
    return torch.matmul(x.float(), hadamard(x.shape[-1], x.device))


def _lloyd_index(u: torch.Tensor, boundaries: np.ndarray) -> torch.Tensor:
    """Code index per element: the count of boundaries strictly below it (the
    reference's chain of ``u > b`` adds, in one ``bucketize``)."""
    return torch.bucketize(u, _boundaries(boundaries, u.device)).to(torch.uint8)


def _boundaries(boundaries: np.ndarray, device) -> torch.Tensor:
    key = (boundaries.tobytes(), str(device))
    if key not in _BOUNDARIES:
        _BOUNDARIES[key] = _device_table(boundaries, device)
    return _BOUNDARIES[key]


def turbo_codebooks(d: int, device='cpu') -> Tuple[torch.Tensor, torch.Tensor]:
    """(K centroids C3 * sigma [8], V centroids C2 * sigma [4]), f32 products as the
    reference forms them, kept on ``device`` (a CUDA graph may not copy them in)."""
    key = (d, str(device))
    if key not in _CODEBOOKS:
        _CODEBOOKS[key] = tuple(_device_table(c * turbo_sigma(d), device)
                                for c in (LLOYD_C3, LLOYD_C2))
    return _CODEBOOKS[key]


def quantize_rows_turbo_k(k_rot: torch.Tensor, eps: float = 1e-8
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ALREADY-ROTATED K rows [..., D] -> (codes u8 0..15 [..., D], mse_norm [...],
    qjl_norm [...]); code = 3-bit index | (residual >= 0) << 3, and qjl_norm is the
    residual's norm times ``fl(1/sqrt(D))`` (the jitted reference's division by the
    f32 constant sqrt(D))."""
    D = k_rot.shape[-1]
    xf = k_rot.float()
    mse_norm = torch.sqrt((xf * xf).sum(-1) + eps)
    u = xf / mse_norm[..., None]
    idx = _lloyd_index(u, LLOYD_B3 * turbo_sigma(D))
    r = u - turbo_codebooks(D, u.device)[0][idx.long()]
    sign = (r >= 0).to(torch.uint8)
    qjl_norm = torch.sqrt((r * r).sum(-1) + eps) * f32_reciprocal(np.sqrt(D))
    return idx | (sign << 3), mse_norm, qjl_norm


def dequantize_turbo_k(code: torch.Tensor, mse_norm: torch.Tensor,
                       qjl_norm: torch.Tensor) -> torch.Tensor:
    """u8 codes [..., D] -> rotated-domain K: mse_norm * (centroid + qjl_norm * sign)."""
    cent = turbo_codebooks(code.shape[-1], code.device)[0][(code & 0x7).long()]
    sign = ((code >> 3) & 0x1).float() * 2.0 - 1.0
    return mse_norm[..., None] * (cent + qjl_norm[..., None] * sign)


def quantize_rows_turbo_v(v_rot: torch.Tensor, eps: float = 1e-8
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ALREADY-ROTATED V rows [..., D] -> (codes u8 0..3 [..., D], norm [...])."""
    D = v_rot.shape[-1]
    xf = v_rot.float()
    norm = torch.sqrt((xf * xf).sum(-1) + eps)
    return _lloyd_index(xf / norm[..., None], LLOYD_B2 * turbo_sigma(D)), norm


def dequantize_turbo_v(code: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    return norm[..., None] * turbo_codebooks(code.shape[-1], code.device)[1][code.long()]
