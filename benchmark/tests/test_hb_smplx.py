"""SMPL-X's reference and entry, and the packed-operand reader, on the
CPU at a tiny size (55 joints, the shape split 10 + 10, V = 60)."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import gen, harness, timeline
from benchmark.entries import forward_chunked_smplx
from benchmark.reference import mano, smplx

CPU = torch.device("cpu")
CFG = dict(harness.load_json("configs", "smplx_neutral"), n_verts=60,
           n_faces=20)
LIMIT = harness.load_json("limits", "smplx_neutral.bulk_forward")[
    "max_vertex_err_m"]


def draw(seed=3, n=9):
    g = gen.generator(seed, CPU)
    (arrays,) = gen.config_arrays(CFG, g, CPU)
    arrays = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
              else v for k, v in arrays.items()}
    return (arrays, gen.poses(n, CFG, g, CPU).double(),
            gen.shapes(n, CFG, g, CPU).double())


def test_reference_is_mano_on_the_concatenated_basis():
    """Betas and expression against ``shapedirs`` and ``exprdirs`` are
    MANO's equations over the concatenated basis and shape: the two
    references, written apart, agree to float64 rounding (a zero pose row
    takes both small-angle branches)."""
    arrays, pose, shape = draw()
    pose[0] = 0.0
    model = forward_chunked_smplx.reference_model(arrays, CFG["n_betas"])
    nb = CFG["n_betas"]
    got = smplx.forward(model, pose, shape[:, :nb], shape[:, nb:])
    want = mano.forward(arrays, pose, shape)
    assert (got - want).abs().max() < 1e-12
    blocks = list(smplx.forward_blocks(model, pose, shape[:, :nb],
                                       shape[:, nb:], block=4))
    assert [b[:2] for b in blocks] == [(0, 4), (4, 8), (8, 9)]
    # Blocks round as their own batches do (~1e-18 m).
    torch.testing.assert_close(torch.cat([b[2] for b in blocks]), got,
                               rtol=0, atol=1e-15)


def entry(seed=5, rows=12, chunk=5):
    ctx = SimpleNamespace(cfg=CFG, traffic={"rows": rows, "chunk_size": chunk},
                          gen=gen.generator(seed, CPU), device=CPU)
    return forward_chunked_smplx.build(ctx)


def test_entry_is_correct_and_catches_swapped_betas_and_expression():
    """The program through ``forward_chunked`` (K1's CPU path) passes the
    cell's limit; fed expression where betas belong, it fails it."""
    e = entry()
    out = e.call(0)
    assert out.shape == (12, 60, 3)
    err = e.check([(0, 0, out)])["max_vertex_err_m"]
    assert err < LIMIT / 4
    pose, shape = e.inputs[0]
    nb = CFG["n_betas"]
    swapped = torch.cat([shape[:, nb:], shape[:, :nb]], dim=1)
    with torch.no_grad():
        bad = e.forward(e.params, pose, swapped, chunk_size=e.chunk,
                        use_pallas_fused_full=True)
    assert e.check([(0, 0, bad)])["max_vertex_err_m"] > 100 * LIMIT


def test_control_is_the_reference_in_tf32_in_the_programs_place():
    e = entry(rows=6)
    e.control()
    out = e.call(1)
    # No TF32 on the CPU: the control is the reference in float32 there.
    assert e.check([(0, 1, out)])["max_vertex_err_m"] < 1e-5


KERNEL = ("void (anonymous namespace)::fused_forward_kernel<{}>(float "
          "const*, float const*, float const*, float const*, float const*, "
          "int const*, float*, int, int, int, int, int, int)")


def traced(cell, names):
    ops = [(n, 10 * i, 10 * i + 5) for i, n in enumerate(names)]
    tl = timeline.Timeline(ops, [("bench.window", 0, 100)], (0, 100))
    return SimpleNamespace(cell=cell, timeline=tl)


@pytest.mark.parametrize("cell,rows,want", [
    ("smplx_neutral.bulk_forward", 16, 4.143296),
    ("mano_right.bulk_forward", 64, 0.02576),
    ("mano_pair.bulk_forward", 64, 0.02576),
    ("mano_right.bulk_forward", 8, 0.20608),
])
def test_basis_reader_reads_the_row_tile(cell, rows, want):
    """One hand's packed operand over the launches' row tile: 82 x 508 x
    3 x 128 x 4 B of basis and 82 x 55 x 128 x 4 B of weights for
    SMPL-X, 7 x 148 x 3 x 128 x 4 and 7 x 16 x 128 x 4 for MANO."""
    read = harness.load_reader("basis_mb_per_mesh.forward")
    names = [KERNEL.format(rows)] * 3 + ["void at::native::copy_kernel"]
    assert read(traced(cell, names)) == pytest.approx(want)


def test_basis_reader_finds_nothing_without_k1():
    read = harness.load_reader("basis_mb_per_mesh.forward")
    assert read(SimpleNamespace(cell="mano_right.bulk_forward",
                                timeline=None)) is None
    posed = "void (anonymous namespace)::posed_kernel<64, float>(float const*)"
    assert read(traced("mano_right.posed_gather", [posed])) is None
