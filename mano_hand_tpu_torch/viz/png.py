"""Minimal dependency-free image writers (PNG, animated GIF).

A port copy of the JAX package's ``viz/png.py``: for the same arrays the
bytes are identical. PNG (zlib is in the standard library) and GIF89a
(the self-contained LZW below) cover stills and animation previews with
no codec dependency. Images may also be tensors on any device (copied to
the host once).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Sequence, Union

import numpy as np
import torch

from mano_hand_tpu_torch.utils.arrays import as_numpy

PathLike = Union[str, Path]


def _to_u8(image: np.ndarray) -> np.ndarray:
    image = as_numpy(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if image.ndim == 2:
        image = image[..., None].repeat(3, axis=-1)
    return image


def write_png(image: np.ndarray, path: PathLike) -> Path:
    """Write [H, W, 3] (float in [0,1] or uint8) as an RGB PNG."""
    image = _to_u8(image)
    h, w = image.shape[:2]
    raw = b"".join(
        b"\x00" + image[y].tobytes() for y in range(h)  # filter 0 per row
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    path = Path(path)
    path.write_bytes(data)
    return path


def _lzw_encode(indices: np.ndarray, code_bits: int) -> bytes:
    """GIF-flavor LZW: variable-width codes, clear/end markers."""
    clear = 1 << code_bits
    end = clear + 1
    table = {bytes([i]): i for i in range(clear)}
    next_code = end + 1
    width = code_bits + 1

    out_bits: list = []
    acc = 0
    nacc = 0

    def emit(code: int, w: int) -> None:
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += w
        while nacc >= 8:
            out_bits.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    emit(clear, width)
    prefix = b""
    for sym in indices.tobytes():
        trial = prefix + bytes([sym])
        if trial in table:
            prefix = trial
            continue
        emit(table[prefix], width)
        table[trial] = next_code
        next_code += 1
        if next_code > (1 << width) and width < 12:
            width += 1
        elif next_code >= 4096:
            emit(clear, width)
            table = {bytes([i]): i for i in range(clear)}
            next_code = end + 1
            width = code_bits + 1
        prefix = bytes([sym])
    if prefix:
        emit(table[prefix], width)
    emit(end, width)
    if nacc:
        out_bits.append(acc & 0xFF)
    return bytes(out_bits)


def write_gif(
    frames: Union[np.ndarray, Sequence[np.ndarray]],
    path: PathLike,
    fps: int = 20,
    levels: int = 64,
) -> Path:
    """Write [T, H, W, 3] frames as a looping grayscale-quantized GIF89a.

    Each frame is luma-quantized to ``levels`` gray entries — ample for
    shaded-mesh previews and keeps the encoder tiny and deterministic.
    """
    if torch.is_tensor(frames):
        frames = as_numpy(frames)
    frames = [_to_u8(f) for f in frames]
    h, w = frames[0].shape[:2]
    delay_cs = max(2, round(100 / max(fps, 1)))

    # Global 256-entry grayscale palette (levels used, rest padded).
    pal = bytearray()
    for i in range(256):
        g = min(i, levels - 1) * 255 // (levels - 1)
        pal += bytes((g, g, g))

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global palette, 256
    out += bytes(pal)
    out += b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for f in frames:
        luma = (
            0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        )
        idx = np.clip(
            (luma / 255.0 * (levels - 1) + 0.5).astype(np.uint8),
            0, levels - 1,
        )
        out += b"\x21\xF9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00"
        out += b"\x2C" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00"
        out += bytes([8])  # LZW min code size
        data = _lzw_encode(idx.reshape(-1), 8)
        for off in range(0, len(data), 255):
            block = data[off:off + 255]
            out += bytes([len(block)]) + block
        out += b"\x00"
    out += b"\x3B"
    path = Path(path)
    path.write_bytes(bytes(out))
    return path
