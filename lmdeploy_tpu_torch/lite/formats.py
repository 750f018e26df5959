"""Quantized-checkpoint wire formats: AWQ / GPTQ pack & unpack (numpy, load-time).

Copy of ``lmdeploy_tpu/lite/formats.py`` (lines 1-156): converts between the HF
community formats and the kernel layouts (W4A16 nibbles plane-packed along K, see
``ops/quant_matmul.py``; MXFP4 e2m1 codes half-split along K, see
``ops/quant_bmm.py``).

AWQ (autoawq) format:  qweight i32[K, N/8], qzeros i32[K/gs, N/8], scales f16[K/gs, N]
  - 8 nibbles per int32 word along the OUTPUT dim, interleaved order: nibble at
    shift 4*i holds output column ``8*w + AWQ_ORDER[i]``.
GPTQ format:           qweight i32[K/8, N], qzeros i32[K/gs, N/8], scales f16[K/gs, N]
  - 8 nibbles per word along the INPUT dim, sequential order; stored zero points
    are ``z - 1`` (the classic GPTQ off-by-one).
MXFP4 (gpt-oss):       *_blocks u8[..., G, 16], *_scales u8[..., G]
  - 32 e2m1 values per group, two per byte, low nibble first; one ue8m0 exponent
    byte per group (scale 2^(s - 127)).
"""
from __future__ import annotations

import numpy as np

AWQ_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def unpack_awq_qweight(qw: np.ndarray) -> np.ndarray:
    """i32[K, N/8] -> u8[K, N] (values 0..15)."""
    qw = qw.astype(np.uint32)
    K, N8 = qw.shape
    out = np.empty((K, N8 * 8), np.uint8)
    for i in range(8):
        out[:, AWQ_ORDER[i]::8] = ((qw >> (4 * i)) & 0xF).astype(np.uint8)
    return out


def pack_awq_qweight(q: np.ndarray) -> np.ndarray:
    """u8[K, N] -> i32[K, N/8] in AWQ interleaved order."""
    K, N = q.shape
    out = np.zeros((K, N // 8), np.uint32)
    for i in range(8):
        out |= q[:, AWQ_ORDER[i]::8].astype(np.uint32) << (4 * i)
    return out.astype(np.int32)


def unpack_awq_qzeros(qz: np.ndarray) -> np.ndarray:
    """i32[G, N/8] -> f32[G, N] zero points."""
    return unpack_awq_qweight(qz).astype(np.float32)


def unpack_gptq_qweight(qw: np.ndarray) -> np.ndarray:
    """i32[K/8, N] -> u8[K, N] (sequential nibble order along K)."""
    qw = qw.astype(np.uint32)
    K8, N = qw.shape
    out = np.empty((K8 * 8, N), np.uint8)
    for i in range(8):
        out[i::8] = ((qw >> (4 * i)) & 0xF).astype(np.uint8)
    return out


def unpack_gptq_qzeros(qz: np.ndarray) -> np.ndarray:
    """i32[G, N/8] -> f32[G, N]; GPTQ stores z-1, compensate (+1)."""
    qz = qz.astype(np.uint32)
    G, N8 = qz.shape
    out = np.empty((G, N8 * 8), np.uint8)
    for i in range(8):
        out[:, i::8] = ((qz >> (4 * i)) & 0xF).astype(np.uint8)
    return out.astype(np.float32) + 1.0


def to_kernel_packed(q: np.ndarray) -> np.ndarray:
    """u8[K, N] int4 values -> kernel layout i32[K/8, N] ("plane-packed":
    plane j covers rows [j*K/4, (j+1)*K/4); word r holds plane row 2r at bits
    [4j, 4j+4) and plane row 2r+1 at bits [16+4j, 16+4j+4); see
    ops/quant_matmul.py for the bitcast decode this layout enables)."""
    q = np.asarray(q, np.uint32)
    K, N = q.shape
    assert K % 8 == 0, K
    Kq = K // 4
    out = np.zeros((K // 8, N), np.uint32)
    for j in range(4):
        pj = q[j * Kq:(j + 1) * Kq]
        out |= pj[0::2] << (4 * j)
        out |= pj[1::2] << (16 + 4 * j)
    return out.view(np.int32)


def pad_k4(K: int, group_size: int = 128) -> int:
    """K rounded up to a multiple of 4*group_size — the plane-packed layout
    needs each of its 4 K-planes to hold whole quant groups.  Planes take
    contiguous group ranges in K order, so padding lands at the END of K:
    pad q rows are 0, pad scales 1, pad zeros 0 and the activation pads with
    zeros at matmul time ((0-0)*1*0 contributes nothing — exact)."""
    unit = 4 * group_size
    return -(-K // unit) * unit


def _pad_rows(q: np.ndarray, pad_to: int) -> np.ndarray:
    if pad_to and pad_to > q.shape[0]:
        q = np.concatenate(
            [q, np.zeros((pad_to - q.shape[0], q.shape[1]), q.dtype)])
    return q


def pad_groups(a: np.ndarray, pad_to_g: int, value: float) -> np.ndarray:
    """Pad a [G, N] scales/zeros tensor to pad_to_g group rows."""
    a = np.asarray(a, np.float32)
    if pad_to_g and pad_to_g > a.shape[0]:
        a = np.concatenate(
            [a, np.full((pad_to_g - a.shape[0], a.shape[1]), value,
                        np.float32)])
    return a


def awq_qweight_to_kernel(qw: np.ndarray, pad_to: int = 0) -> np.ndarray:
    return to_kernel_packed(_pad_rows(unpack_awq_qweight(qw), pad_to))


def gptq_qweight_to_kernel(qw: np.ndarray, pad_to: int = 0) -> np.ndarray:
    return to_kernel_packed(_pad_rows(unpack_gptq_qweight(qw), pad_to))


# -- MXFP4 (gpt-oss checkpoints) --------------------------------------------------
# e2m1 nibble values; sign bit 0x8 (code 8 is -0.0, code 1 the subnormal 0.5)
_E2M1 = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
                  -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], np.float32)


def mxfp4_codes(blocks: np.ndarray) -> np.ndarray:
    """u8 blocks [..., G, 16] (2 e2m1 per byte, low nibble first) -> raw e2m1
    codes u8 [..., G*32] (no dequantization: the runtime kernel decodes)."""
    lo = blocks & 0xF
    hi = blocks >> 4
    out = np.stack([lo, hi], axis=-1).reshape(*blocks.shape[:-2],
                                              blocks.shape[-2] * 32)
    return out.astype(np.uint8)


def pack_halfsplit(codes: np.ndarray) -> np.ndarray:
    """4-bit codes [..., K, N] -> u8 [..., K/2, N] in the kernel's half-split
    layout (low nibble = input row r, high nibble = row K/2 + r)."""
    K = codes.shape[-2]
    return (codes[..., :K // 2, :]
            | (codes[..., K // 2:, :] << 4)).astype(np.uint8)


def ue8m0_to_f32(scales: np.ndarray) -> np.ndarray:
    """ue8m0 exponent bytes -> f32 2^(s-127) group scales."""
    return np.exp2(scales.astype(np.int32) - 127).astype(np.float32)


def mxfp4_dequant(blocks: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """u8 blocks [..., G, 16] (2 e2m1 per byte, low nibble first) + ue8m0
    scales u8 [..., G] (2^(s-127) per 32-value group) -> f32 [..., G*32]."""
    lo = _E2M1[blocks & 0xF]
    hi = _E2M1[blocks >> 4]
    vals = np.stack([lo, hi], axis=-1).reshape(*blocks.shape[:-1], 32)
    scale = np.exp2(scales.astype(np.int32) - 127).astype(np.float32)
    out = vals * scale[..., None]
    return out.reshape(*blocks.shape[:-2], blocks.shape[-2] * 32)
