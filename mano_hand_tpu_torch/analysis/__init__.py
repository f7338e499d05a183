"""Project-invariant static analysis for the port (``mano analyze``).

The port's counterpart of the JAX package's ``analysis/``, pointed at
``mano_hand_tpu_torch/``. Three checkers:

* :mod:`.policy` — an AST linter of the port's written rules: unbounded
  retry loops around device calls, wall-clock ``time.time()`` in
  deadline/TTL arithmetic, device work lexically inside the engine's
  ``_lock``, ``_install_lock`` or ``_completion_lock``.
* :mod:`.locks` — the ``with`` nesting graph (plus intra-class call
  edges) of the serving engine and its neighbours, held to the port's
  stated lock order, with no cycle and nothing taken under a leaf.
* :mod:`.fx_audit` — traces every program family of the engine on the
  CPU (``make_fx``) and fails on float64 values, host syncs, a bf16
  family off its dtype policy, or op counts off the committed
  ``baseline.json``.

The JAX package's ``jaxpr_audit.py`` and ``lockstep.py`` have no port
counterpart beyond ``fx_audit``: the port's two-hand kernel (K5) is K1's
own kernel with a hand axis, so there is no pair to keep in lockstep.

Audited sites silence a rule with ``# analysis: allow(<rule>)`` on (or
directly above) the flagged line. ``--update-baseline`` recommits
intentional op-count changes.
"""

from __future__ import annotations

from .common import (  # noqa: F401
    Finding,
    baseline_path,
    load_baseline,
    save_baseline,
)
from .policy import POLICY_RULES, lint_paths, lint_source  # noqa: F401
from .locks import check_lock_discipline  # noqa: F401
