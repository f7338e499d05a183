"""Packed operand K1/K5 streams a mesh: the median, over the traced
window's K1/K5 launches, of one hand's vertex-tiled basis and weights
(``ops/fused_forward.py:_pack``: nsub kpad 3 128 4 B of basis and nsub J
128 4 B of weights, nsub = ceil(V / 128), from the cell's configuration)
over the launch's row tile R, in 10^6 B. Every row tile streams the whole
packed operand through its blocks, whatever the vertex split, so a mesh
costs that over R. R is read from the kernel's template argument, as the
profiler names it (``fused_forward_kernel<R>(...)``)."""

import re
import statistics

from benchmark import harness

KERNEL = re.compile(r"fused_forward_kernel<(\d+)>")
VERT_TILE = 128


def operand_bytes(cfg: dict) -> int:
    """One hand's packed basis and weights, in bytes."""
    v, j, s = cfg["n_verts"], cfg["n_joints"], cfg["n_shape"]
    nsub = -(-v // VERT_TILE)
    kpad = -(-(s + 1 + 9 * (j - 1)) // 4) * 4
    return 4 * nsub * VERT_TILE * (3 * kpad + j)


def read(r):
    if r.timeline is None:
        return None
    tiles = [int(m.group(1)) for name, _, _ in r.timeline.device
             for m in [KERNEL.search(name)] if m]
    if not tiles:
        return None
    cell = harness.find_cell(harness.load_spec(), r.cell)
    hand = operand_bytes(harness.load_json("configs", cell["config"]))
    return statistics.median(hand / rows for rows in tiles) / 1e6
