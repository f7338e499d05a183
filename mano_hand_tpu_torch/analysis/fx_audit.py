"""FX program auditor: trace every program family of the serving engine
on the CPU and audit its ATen graph (the port's counterpart of the JAX
package's ``analysis/jaxpr_audit.py``).

Each family is first run once eagerly (so the per-asset caches a batch
finds warm — packed operands, index tensors — are built, as the engine's
warm-up builds them), then traced with
``torch.fx.experimental.proxy_tensor.make_fx`` on CPU tensors: the graph
is the work one batch of that family does. On the CPU the kernel
wrappers run their plain versions, so a kernel family's graph is its
plain version's. The audit fails on

* **float64 values** — an f64 tensor anywhere in the graph doubles the
  bytes of the serving path and changes the numerics of the f32
  contract (torch's own 0-d symbolic zeros, ``_efficientzerotensor``
  and the copies made of them, carry no data and are not counted);
* **host syncs** — ``.item()`` (``aten._local_scalar_dense``) inside a
  program waits for the device on every batch;
* **the bf16 dtype policy** — a bf16-tier family's contractions must
  accumulate into f32 (no contraction with a bf16 output), its outputs
  must be f32, and some contraction must take a bf16-rounded operand
  (else the family is an f32 program under a bf16 name);
* **op counts** — each family's histogram of ATen ops must match the
  committed ``analysis/baseline.json``, so an accidental extra pass
  shows in review. Intentional changes: ``--update-baseline``.

The JAX auditor's donation check has no counterpart here: the port's
card programs are CUDA graphs over static buffers, which donate nothing.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

from .common import Finding

#: Fixed trace shapes: op counts are only comparable at fixed shapes, and
#: small ones keep the audit in seconds.
_BUCKET = 8
_CAPACITY = 4

#: ATen contractions (matched by the op's name).
_CONTRACTIONS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot",
                 "mv", "einsum", "linear"}

#: Ops that move or reshape values without computing them: the ancestry
#: of a contraction operand is followed through these.
_PASS_THROUGH = {"view", "_unsafe_view", "reshape", "permute", "expand",
                 "transpose", "t", "unsqueeze", "squeeze", "clone",
                 "contiguous", "slice", "select", "_to_copy", "alias",
                 "index", "cat", "stack"}

HERE = "mano_hand_tpu_torch/analysis/fx_audit.py"


class ProgramSpec(NamedTuple):
    name: str               # e.g. "gathered"
    family: str             # the family the engine serves it as
    fn: Callable            # positional-args callable to trace
    args: Tuple             # CPU example arguments
    bf16: bool = False      # a bf16-tier family: the dtype policy applies


def build_program_specs() -> List[ProgramSpec]:
    """The audited programs, as the serving engine builds them (its
    ``_EagerProgram`` bodies on a CPU engine; the same functions the card
    captures)."""
    import torch

    from mano_hand_tpu_torch.assets import mirror_params, synthetic_params
    from mano_hand_tpu_torch.fitting import lm
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops import fused_forward, fused_posed

    f32, bf16 = torch.float32, torch.bfloat16
    params = synthetic_params(seed=0, dtype=f32, device="cpu")
    stacked = core.stack_params(params, mirror_params(params))
    j, s = params.n_joints, params.n_shape
    pose = torch.zeros((_BUCKET, j, 3), dtype=f32)
    shape = torch.zeros((_BUCKET, s), dtype=f32)
    shaped = core.specialize(params, torch.zeros(s, dtype=f32))
    table = core.subject_table(params, _CAPACITY)
    idx = torch.zeros((_BUCKET,), dtype=torch.int32)
    pose2 = torch.zeros((2, _BUCKET, j, 3), dtype=f32)
    shape2 = torch.zeros((2, _BUCKET, s), dtype=f32)

    def full(p, sh):
        return core.forward_batched(params, p, sh).verts

    return [
        ProgramSpec("full", "full", full, (pose, shape)),
        ProgramSpec("posed", "posed",
                    lambda p: core.forward_posed_batched(shaped, p).verts,
                    (pose,)),
        ProgramSpec("gathered", "gathered",
                    lambda ix, p: core.forward_posed_gather(
                        table, ix, p).verts, (idx, pose)),
        ProgramSpec("gathered_bf16", "gathered",
                    lambda ix, p: core.forward_posed_gather(
                        table, ix, p, compute_dtype=bf16).verts,
                    (idx, pose), bf16=True),
        # The kernel families: K1, K5, K2 and K2-bf16 (their plain
        # versions on the CPU).
        ProgramSpec("fused_one", "fused",
                    lambda p, sh: fused_forward.forward_verts_fused_full(
                        params, p, sh), (pose, shape)),
        ProgramSpec("fused_two", "fused",
                    lambda p, sh:
                    fused_forward.forward_verts_fused_full_hands(
                        stacked, p, sh), (pose2, shape2)),
        ProgramSpec("gathered_fused", "fused",
                    lambda ix, p: fused_posed.forward_posed_gather_fused(
                        table, ix, p), (idx, pose)),
        ProgramSpec("gathered_fused_bf16", "fused",
                    lambda ix, p: fused_posed.forward_posed_gather_fused(
                        table, ix, p, compute_dtype=bf16), (idx, pose),
                    bf16=True),
        # The CPU tier: the plain forward on the engine's params.
        ProgramSpec("cpu_fallback", "cpu_fallback", full, (pose, shape)),
        # A stream session's frame solve: the frozen-shape LM tracker
        # step on a joints target (serving/streams.py over
        # fitting/tracking.py), initial pose and betas as arguments.
        ProgramSpec("stream_fit", "stream_fit",
                    lambda tgt, p0, fs: lm.fit_lm(
                        params, tgt, n_steps=2, data_term="joints",
                        init={"pose": p0}, frozen_shape=fs).pose,
                    (torch.zeros((j, 3), dtype=f32),
                     torch.zeros((j, 3), dtype=f32),
                     torch.zeros((s,), dtype=f32))),
    ]


def _op_name(node) -> str:
    """``aten.mm.default`` -> ``mm``."""
    parts = str(node.target).split(".")
    return parts[1] if len(parts) > 2 else parts[-1]


def _dtype(node):
    val = node.meta.get("val")
    return getattr(val, "dtype", None)


def _zero_derived(graph) -> set:
    """Nodes that are torch's 0-d symbolic zeros or copies of them."""
    zero = set()
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = _op_name(node)
        if name == "_efficientzerotensor" or (
                name in ("_to_copy", "clone") and node.args
                and node.args[0] in zero):
            zero.add(node)
    return zero


def _bf16_rounded(node, depth: int = 8) -> bool:
    """Whether ``node``'s value comes from a bf16 value through
    pass-through ops only."""
    import torch

    frontier = [node]
    for _ in range(depth):
        nxt = []
        for n in frontier:
            if not hasattr(n, "op"):
                continue
            if _dtype(n) == torch.bfloat16:
                return True
            if n.op == "call_function" and _op_name(n) in _PASS_THROUGH:
                for a in n.args:
                    nxt.extend(a if isinstance(a, (list, tuple)) else [a])
        frontier = nxt
    return False


def _walk(graph):
    """(op histogram, f64 nodes, host-sync nodes, contractions as
    (node, operand nodes), output nodes)."""
    import torch

    counts: Dict[str, int] = collections.Counter()
    zero = _zero_derived(graph)
    f64, syncs, contractions, outputs = [], [], [], []
    for node in graph.nodes:
        if node.op == "output":
            outs = node.args[0]
            outputs = list(outs) if isinstance(outs, (list, tuple)) \
                else [outs]
            continue
        if node.op != "call_function":
            continue
        counts[str(node.target)] += 1
        name = _op_name(node)
        if _dtype(node) in (torch.float64, torch.complex128) \
                and node not in zero:
            f64.append(node)
        if name in ("_local_scalar_dense", "item"):
            syncs.append(node)
        if name in _CONTRACTIONS:
            contractions.append((node, [a for a in node.args
                                        if hasattr(a, "op")]))
    return dict(sorted(counts.items())), f64, syncs, contractions, outputs


def _trace(spec: ProgramSpec):
    """(graph, None) or (None, the host-sync error) for one program: run
    once eagerly (warm caches), then trace on the CPU."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    with torch.no_grad():
        spec.fn(*spec.args)
        try:
            return make_fx(spec.fn, tracing_mode="real")(*spec.args), None
        except RuntimeError as e:
            if "_local_scalar_dense" in str(e):
                return None, str(e).splitlines()[0]
            raise


def audit_programs(
    baseline: Optional[dict],
    specs: Optional[Sequence[ProgramSpec]] = None,
) -> Tuple[List[Finding], dict]:
    """Audit all program families.

    Returns (findings, measured) where ``measured`` is the would-be
    baseline ``{"programs": {name: {"ops": {...}}}}`` for
    ``--update-baseline``.
    """
    import torch

    findings: List[Finding] = []
    measured: dict = {"programs": {}}
    if specs is None:
        specs = build_program_specs()

    for spec in specs:
        graph, sync_error = _trace(spec)
        if graph is None:
            findings.append(Finding(
                "fx-host-sync", HERE, 0,
                f"program {spec.name!r} reads a device value on the host "
                f"while it runs ({sync_error[:120]}) — a per-batch wait "
                "for the card on the dispatch path"))
            continue
        counts, f64, syncs, contractions, outputs = _walk(graph.graph)
        measured["programs"][spec.name] = {"ops": counts}
        if f64:
            findings.append(Finding(
                "fx-f64-leak", HERE, 0,
                f"program {spec.name!r} carries {len(f64)} float64 "
                f"value(s) (first: {f64[0].target}) — the serving "
                "contract is f32 end to end"))
        if syncs:
            findings.append(Finding(
                "fx-host-sync", HERE, 0,
                f"program {spec.name!r} syncs with the host "
                f"({syncs[0].target}) — a per-batch wait for the card"))
        if spec.bf16:
            bf16_out = [n for n, _ in contractions
                        if _dtype(n) == torch.bfloat16]
            if bf16_out:
                findings.append(Finding(
                    "fx-dtype-policy", HERE, 0,
                    f"program {spec.name!r}: {len(bf16_out)} "
                    "contraction(s) accumulate in bf16 — the committed "
                    "policy is bf16 operands with f32 accumulation "
                    "(serving/precision.py)"))
            if not any(_bf16_rounded(a) for _, ops_ in contractions
                       for a in ops_):
                findings.append(Finding(
                    "fx-dtype-policy", HERE, 0,
                    f"program {spec.name!r} is a bf16 family but no "
                    "contraction takes a bf16-rounded operand — the "
                    "compute_dtype is not reaching the contractions"))
            out_dtypes = sorted({str(_dtype(n)) for n in outputs})
            if any(d != "torch.float32" for d in out_dtypes):
                findings.append(Finding(
                    "fx-dtype-policy", HERE, 0,
                    f"program {spec.name!r} outputs {out_dtypes} — the "
                    "engine delivers f32 vertices on every tier"))

        base = ((baseline or {}).get("programs", {})
                .get(spec.name, {}).get("ops"))
        if base is None:
            findings.append(Finding(
                "fx-baseline", HERE, 0,
                f"program {spec.name!r} has no committed op-count "
                "baseline — run `python -m mano_hand_tpu_torch analyze "
                "--update-baseline` and commit analysis/baseline.json"))
        elif base != counts:
            delta = {k: (base.get(k, 0), counts.get(k, 0))
                     for k in sorted(set(base) | set(counts))
                     if base.get(k, 0) != counts.get(k, 0)}
            findings.append(Finding(
                "fx-op-drift", HERE, 0,
                f"program {spec.name!r} op counts drifted from the "
                f"baseline: {delta} (was -> is). Intentional? "
                "`--update-baseline` and say why in the PR; unintended "
                "growth lands on the card as launches and memory "
                "traffic"))
    return findings, measured
