"""The yardstick: the work each call needs, and the chip's peaks.

The operation and byte counts are the algorithm's, from the shapes alone
(the rules of ``chip_smoke.py``'s ``k1_work`` and ``k2_work``, rewritten
here so the benchmark owns them): whatever kernels implement the
forward, a call needs this much. Operations are fp32 FLOP with a
multiply-add counted as two; each input byte is read once and each
output byte written once.
"""

from __future__ import annotations

#: Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
#: 700 W power limit): fp32 outside the tensor cores, HBM3 bandwidth.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def peaks(device_name: str) -> tuple:
    """(fp32 FLOP/s, bytes/s) of the named card. Only the H100 is
    known; any other card raises, so no share is stated against a wrong
    peak."""
    if "H100" not in device_name:
        raise ValueError(f"no published peaks for {device_name!r}")
    return H100_FP32_FLOPS, H100_HBM_BYTES_PER_S


def forward_work(b: int, v: int, j: int, s: int) -> tuple:
    """(FLOP, bytes) of the full forward of ``b`` meshes: the blend over
    K = S + 1 + 9 (J - 1) coefficients (shape, template, pose
    correctives), the 12-plane skinning blend, the per-vertex 3x3 apply;
    pose, shape and the packed asset read once, vertices written once."""
    k = s + 1 + 9 * (j - 1)
    flops = b * (2 * k * 3 * v + 2 * 12 * j * v + 18 * v)
    kpad = -(-k // 4) * 4
    asset = 4 * (kpad * 3 * v + j * v + j * 3 * (s + 1) + j)
    moved = 4 * b * (3 * j + s) + asset + 4 * b * v * 3
    return flops, moved


def posed_work(b: int, rows_used: int, v: int, j: int) -> tuple:
    """(FLOP, bytes) of the gathered pose-only forward of ``b`` meshes:
    the pose blend over 9 (J - 1) coefficients plus the template add,
    the skinning; the ``rows_used`` subject rows the call indexes, pose,
    index and asset read once, vertices written once."""
    p = 9 * (j - 1)
    flops = b * (2 * p * 3 * v + 3 * v + 2 * 12 * j * v + 18 * v)
    ppad = -(-p // 4) * 4
    asset = 4 * (ppad * 3 * v + j * v + j)
    table = 4 * rows_used * (v * 3 + j * 3)
    moved = 4 * b * (3 * j + 1) + table + asset + 4 * b * v * 3
    return flops, moved


def bound_s(flops: float, moved: float, device_name: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the fp32 peak and the bytes over the memory rate."""
    peak_flops, peak_bw = peaks(device_name)
    return max(flops / peak_flops, moved / peak_bw)
