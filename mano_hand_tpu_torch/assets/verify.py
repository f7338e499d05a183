"""Truth anchors for loaded MANO assets: the asset audit.

A port copy of the JAX package's ``assets/verify.py``. The official MANO
pickles are license-gated, so a user with the licensed file gets an
immediate verdict from ``verify_asset``:

- **gates** (hard failures): the public structural facts of MANO — 778
  vertices, 1538 faces, 16 joints, 45-dim finger-pose space, 10 shape
  dims, the 3-per-finger kinematic tree (``constants.MANO_PARENTS``) —
  plus invariants any genuine skinning model satisfies (LBS weight rows
  and joint-regressor rows are convex combinations; every float field is
  finite; the float64 oracle forward, ``models/oracle.py``, is finite at
  the rest pose with its root joint inside the template's bounding box).
- **checks** (warnings): hand-scale bounding box, near-orthogonal PCA
  basis, manifold edges, all vertices referenced.
- **digests**: canonical SHA-256 per decoded array (float64 bytes, int64
  for faces, with a shape header) and one combined digest. They equal
  the JAX package's letter for letter for the same file, so a digest
  pinned with ``expect`` holds in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from mano_hand_tpu_torch import constants as C
from mano_hand_tpu_torch.assets.loader import load_model
from mano_hand_tpu_torch.assets.schema import ARRAY_FIELDS, ManoParams
from mano_hand_tpu_torch.utils.arrays import as_numpy
from mano_hand_tpu_torch.models import oracle

# Public structural facts of the official MANO release (counts are in the
# MANO paper and every open-source consumer; see SURVEY.md §2 C1).
OFFICIAL = {
    "n_verts": 778,
    "n_faces": 1538,
    "n_joints": 16,
    "n_shape": 10,
    "n_pose_basis": 135,
    "pca_dims": 45,
}

# Combined digests of independently verified official assets, keyed by
# side. Empty by construction: the license forbids shipping anything
# derived from the asset, digests included, without the user's own copy.
# Populate locally (or pass --expect) after verifying a download once.
KNOWN_DIGESTS: dict = {}


@dataclasses.dataclass(frozen=True)
class Finding:
    level: str      # "gate" | "check"
    name: str
    ok: bool
    detail: str


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    findings: Tuple[Finding, ...]
    digests: dict           # field -> sha256 hex; plus "combined"
    side: str

    @property
    def gates_ok(self) -> bool:
        return all(f.ok for f in self.findings if f.level == "gate")

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.level == "check" and not f.ok]


def _host_params(p: ManoParams) -> ManoParams:
    """``p`` with every array field a host NumPy array (the audit reads
    them with NumPy)."""
    return dataclasses.replace(
        p, **{f: as_numpy(getattr(p, f)) for f in ARRAY_FIELDS})


def _digest(arr) -> str:
    """Canonical SHA-256: f64 (int64 for faces) C-order bytes, shape-tagged
    so e.g. a transposed regressor cannot collide."""
    arr = as_numpy(arr)
    a = np.ascontiguousarray(
        arr,
        dtype=np.int64 if np.issubdtype(arr.dtype, np.integer)
        else np.float64,
    )
    h = hashlib.sha256()
    h.update(repr((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def compute_digests(p: ManoParams) -> dict:
    digests = {f: _digest(getattr(p, f)) for f in ARRAY_FIELDS}
    combined = hashlib.sha256(
        "".join(f"{k}:{digests[k]};" for k in sorted(digests)).encode()
    ).hexdigest()
    digests["combined"] = combined
    return digests


def _structure_gates(p: ManoParams, out: List[Finding]) -> None:
    def gate(name, ok, detail):
        out.append(Finding("gate", name, bool(ok), detail))

    gate("n_verts", p.n_verts == OFFICIAL["n_verts"],
         f"{p.n_verts} (official {OFFICIAL['n_verts']})")
    gate("n_faces", p.faces.shape[0] == OFFICIAL["n_faces"],
         f"{p.faces.shape[0]} (official {OFFICIAL['n_faces']})")
    gate("n_joints", p.n_joints == OFFICIAL["n_joints"],
         f"{p.n_joints} (official {OFFICIAL['n_joints']})")
    gate("n_shape", p.n_shape == OFFICIAL["n_shape"],
         f"{p.n_shape} (official {OFFICIAL['n_shape']})")
    gate("n_pose_basis",
         p.pose_basis.shape[-1] == OFFICIAL["n_pose_basis"],
         f"{p.pose_basis.shape[-1]} (official {OFFICIAL['n_pose_basis']})")
    gate("pca_dims", p.pca_basis.shape == (OFFICIAL["pca_dims"],) * 2,
         f"{tuple(p.pca_basis.shape)} "
         f"(official {(OFFICIAL['pca_dims'],) * 2})")
    gate("kinematic_tree", tuple(p.parents) == C.MANO_PARENTS,
         "3-joints-per-finger MANO tree"
         if tuple(p.parents) == C.MANO_PARENTS
         else f"parents={tuple(p.parents)}")


def _numeric_gates(p: ManoParams, out: List[Finding]) -> None:
    def gate(name, ok, detail):
        out.append(Finding("gate", name, bool(ok), detail))

    w = np.asarray(p.lbs_weights, np.float64)
    row_err = float(np.abs(w.sum(axis=1) - 1.0).max())
    gate("lbs_rows_sum_to_1", row_err < 1e-4,
         f"max |row sum - 1| = {row_err:.2e}")
    gate("lbs_nonnegative", float(w.min()) > -1e-6,
         f"min weight = {float(w.min()):.2e}")

    jr = np.asarray(p.j_regressor, np.float64)
    jr_err = float(np.abs(jr.sum(axis=1) - 1.0).max())
    gate("jreg_rows_sum_to_1", jr_err < 1e-4,
         f"max |row sum - 1| = {jr_err:.2e}")

    finite = all(
        np.isfinite(np.asarray(getattr(p, f))).all()
        for f in ARRAY_FIELDS if f != "faces"
    )
    gate("all_finite", finite, "every float field finite"
         if finite else "non-finite values present")

    # f64 oracle forward at rest pose: the end-to-end decode actually
    # produces a hand (finite verts, regressed root joint inside the
    # template bounding box).
    res = oracle.forward(p)
    v = np.asarray(res.verts)
    ok = bool(np.isfinite(v).all())
    lo, hi = np.asarray(p.v_template).min(0), np.asarray(p.v_template).max(0)
    root = np.asarray(res.joints)[0]
    inside = bool((root >= lo - 1e-6).all() and (root <= hi + 1e-6).all())
    gate("oracle_rest_forward", ok and inside,
         f"rest verts finite={ok}, root joint inside template bbox="
         f"{inside}")


def _quality_checks(p: ManoParams, out: List[Finding]) -> None:
    def check(name, ok, detail):
        out.append(Finding("check", name, bool(ok), detail))

    vt = np.asarray(p.v_template, np.float64)
    diag = float(np.linalg.norm(vt.max(0) - vt.min(0)))
    check("hand_scale", 0.05 < diag < 0.6,
          f"template bbox diagonal {diag * 100:.1f} cm "
          "(a hand is ~10-25 cm)")

    pb = np.asarray(p.pca_basis, np.float64)
    gram = pb @ pb.T
    off = gram - np.diag(np.diag(gram))
    scale = max(float(np.abs(np.diag(gram)).max()), 1e-12)
    ortho = float(np.abs(off).max()) / scale
    check("pca_near_orthogonal", ortho < 1e-3,
          f"max off-diag Gram / max diag = {ortho:.2e}")

    faces = np.asarray(p.faces)
    used = np.zeros(p.n_verts, bool)
    used[faces.ravel()] = True
    check("all_verts_referenced", bool(used.all()),
          f"{int(used.sum())}/{p.n_verts} vertices appear in faces")

    edges = np.sort(
        np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    nonmanifold = int((counts > 2).sum())
    check("manifold_edges", nonmanifold == 0,
          f"{nonmanifold} edges shared by >2 faces")


def verify_asset(path, side: Optional[str] = None,
                 golden=None, device=None) -> VerifyReport:
    """Load ``path`` through the standard loader stack (in float64, onto
    ``device``: default ``cuda``, ``device="cpu"`` explicitly for the CPU)
    and audit it on the host.

    golden: optional second asset path; decoded arrays are diffed
    numerically (gate: max |delta| < 1e-9 — byte-level agreement of two
    copies of the same official file, format conversions included).
    """
    p = _host_params(load_model(path, side=side, device=device,
                                dtype=torch.float64))
    findings: List[Finding] = []
    _structure_gates(p, findings)
    _numeric_gates(p, findings)
    _quality_checks(p, findings)
    digests = compute_digests(p)

    known = KNOWN_DIGESTS.get(p.side)
    if known is not None:
        findings.append(Finding(
            "gate", "known_digest", digests["combined"] == known,
            f"combined {digests['combined'][:16]}... vs known "
            f"{known[:16]}..."))

    if golden is not None:
        g = _host_params(load_model(golden, side=side, device=device,
                                    dtype=torch.float64))
        worst = ("", 0.0)
        for f in ARRAY_FIELDS:
            a = np.asarray(getattr(p, f), np.float64)
            b = np.asarray(getattr(g, f), np.float64)
            if a.shape != b.shape:
                worst = (f, float("inf"))
                break
            d = float(np.abs(a - b).max()) if a.size else 0.0
            if d > worst[1]:
                worst = (f, d)
        findings.append(Finding(
            "gate", "matches_golden", worst[1] < 1e-9,
            f"max |delta| = {worst[1]:.3g} ({worst[0] or 'all fields'})"
            if np.isfinite(worst[1])
            else f"shape mismatch in {worst[0]}"))

    return VerifyReport(tuple(findings), digests, p.side)


def format_report(report: VerifyReport, path,
                  expect: Optional[str] = None) -> Tuple[str, int]:
    """Human-readable report + process return code (0 ok / 1 gate fail)."""
    lines = [f"verify {path} (side={report.side})"]
    for f in report.findings:
        mark = "PASS" if f.ok else ("FAIL" if f.level == "gate" else "WARN")
        lines.append(f"  [{mark}] {f.name}: {f.detail}")
    lines.append("  digests (sha256 of canonical f64 decode):")
    for k in sorted(report.digests):
        if k != "combined":
            lines.append(f"    {k}: {report.digests[k]}")
    lines.append(f"    combined: {report.digests['combined']}")
    ok = report.gates_ok
    if expect is not None:
        match = report.digests["combined"] == expect
        lines.append(f"  [{'PASS' if match else 'FAIL'}] expected digest: "
                     f"{'match' if match else 'MISMATCH'}")
        ok = ok and match
    lines.append("RESULT: " + ("OK" if ok else "GATE FAILURES — this does "
                               "not decode like an official MANO asset"))
    return "\n".join(lines), 0 if ok else 1


def report_json(report: VerifyReport, expect: Optional[str] = None) -> str:
    out = {
        "side": report.side,
        "gates_ok": report.gates_ok,
        "findings": [dataclasses.asdict(f) for f in report.findings],
        "digests": report.digests,
    }
    if expect is not None:
        out["expected_digest"] = expect
        out["expected_digest_match"] = (
            report.digests["combined"] == expect)
    return json.dumps(out, indent=2)
