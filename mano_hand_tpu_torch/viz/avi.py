"""Uncompressed AVI (RIFF) video writer: standard library only, no codecs.

A port copy of the JAX package's ``viz/avi.py``: for the same frames the
bytes are identical. [T, H, W, 3] frame stacks from
``viz.render_sequence`` become an AVI in the 'DIB ' (uncompressed 24-bit
BGR) stream format every mainstream player accepts. Frames may also be a
tensor on any device (copied to the host once).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from mano_hand_tpu_torch.utils.arrays import as_numpy
from mano_hand_tpu_torch.viz.png import _to_u8

PathLike = Union[str, Path]

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def _u8_frames(frames) -> np.ndarray:
    arr = as_numpy(frames)
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"expected [T, H, W, 3] frames, got {arr.shape}")
    # Shared quantization with the PNG/GIF writers so all three formats
    # emit identical pixels for the same render.
    return _to_u8(arr)


def _dib_frame(frame: np.ndarray, stride: int) -> bytes:
    """RGB top-down -> padded BGR bottom-up rows (the DIB layout)."""
    h, w, _ = frame.shape
    bgr = frame[::-1, :, ::-1]  # flip rows, swap channels
    row_bytes = w * 3
    if stride == row_bytes:
        return bgr.tobytes()
    padded = np.zeros((h, stride), np.uint8)
    padded[:, :row_bytes] = bgr.reshape(h, row_bytes)
    return padded.tobytes()


def write_avi(
    frames: Union[np.ndarray, Sequence[np.ndarray]],
    path: PathLike,
    fps: int = 20,
) -> Path:
    """Write [T, H, W, 3] frames (uint8 or float in [0,1]) as an AVI file.

    Single 'vids' stream, BI_RGB (uncompressed) 24-bit DIB frames, with the
    idx1 index chunk for seekable playback.
    """
    arr = _u8_frames(frames)
    t, h, w, _ = arr.shape
    if t == 0:
        raise ValueError("cannot write an AVI with zero frames")
    stride = (w * 3 + 3) & ~3  # DIB rows pad to 4-byte boundaries
    frame_size = stride * h

    def chunk(tag: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return tag + struct.pack("<I", len(payload)) + payload + pad

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    avih = struct.pack(
        "<10I4x12x",
        int(1_000_000 // max(fps, 1)),   # dwMicroSecPerFrame
        frame_size * fps,                # dwMaxBytesPerSec
        0,                               # dwPaddingGranularity
        _AVIF_HASINDEX,                  # dwFlags
        t,                               # dwTotalFrames
        0,                               # dwInitialFrames
        1,                               # dwStreams
        frame_size,                      # dwSuggestedBufferSize
        w,                               # dwWidth
        h,                               # dwHeight (+4x12x: 4 reserved I)
    )
    strh = struct.pack(
        "<4s4sIHHIIIIIIiI4H",
        b"vids", b"DIB ",
        0, 0, 0,                         # dwFlags, wPriority, wLanguage
        0,                               # dwInitialFrames
        1, max(fps, 1),                  # dwScale / dwRate = frame period
        0, t,                            # dwStart, dwLength (frames)
        frame_size,                      # dwSuggestedBufferSize
        -1, 0,                           # dwQuality (default), dwSampleSize
        0, 0, w, h,                      # rcFrame
    )
    # BITMAPINFOHEADER: biHeight > 0 declares bottom-up row order.
    strf = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, frame_size, 0, 0, 0, 0
    )
    hdrl = lst(
        b"hdrl",
        chunk(b"avih", avih)
        + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
    )

    # O(T) assembly: collect chunks in lists and join once (+= on bytes
    # would copy the whole growing buffer per frame).
    movi_parts = [b"movi"]
    index_parts = []
    offset = 4  # past the 'movi' fourcc
    for i in range(t):
        # idx1 offsets point at the chunk fourcc, relative to 'movi'.
        index_parts.append(struct.pack(
            "<4sIII", b"00db", _AVIIF_KEYFRAME, offset, frame_size
        ))
        frame_chunk = chunk(b"00db", _dib_frame(arr[i], stride))
        movi_parts.append(frame_chunk)
        offset += len(frame_chunk)
    movi = chunk(b"LIST", b"".join(movi_parts))

    riff_payload = b"AVI " + hdrl + movi + chunk(b"idx1", b"".join(index_parts))
    path = Path(path)
    with open(path, "wb") as f:
        f.write(chunk(b"RIFF", riff_payload))
    return path


def read_avi_info(path: PathLike) -> dict:
    """Parse an AVI's headers (and first frame) back — the test-side dual of
    ``write_avi``; also a quick integrity check for exported clips."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not a RIFF/AVI file")
    (micro_per_frame, _, _, flags, total_frames, _, streams, _, width,
     height) = struct.unpack_from("<10I", data, data.index(b"avih") + 8)
    strf_off = data.index(b"strf") + 8
    (_, bw, bh, _, bits, compression, size_image) = struct.unpack_from(
        "<IiiHHII", data, strf_off
    )
    movi_off = data.index(b"movi")
    first_off = movi_off + 4
    tag, first_size = data[first_off:first_off + 4], struct.unpack_from(
        "<I", data, first_off + 4
    )[0]
    stride = (bw * 3 + 3) & ~3
    raw = np.frombuffer(
        data, np.uint8, count=first_size, offset=first_off + 8
    ).reshape(bh, stride)[:, : bw * 3].reshape(bh, bw, 3)
    first_frame = raw[::-1, :, ::-1]  # back to RGB top-down
    return {
        "width": width,
        "height": height,
        "n_frames": total_frames,
        "fps": round(1_000_000 / micro_per_frame) if micro_per_frame else 0,
        "streams": streams,
        "has_index": bool(flags & _AVIF_HASINDEX),
        "bits": bits,
        "compression": compression,
        "first_chunk_tag": tag.decode(),
        "first_frame": first_frame,
    }
