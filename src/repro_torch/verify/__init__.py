"""Turn the paper's model checker on the serving runtime itself (the
port's copy of ``repro.verify``).

The port's Promela substrate (:mod:`repro_torch.core.promela`) and
explicit-state explorer (:mod:`repro_torch.core.explorer`) were built to
verify the *paper's* tuning models.  This package points the same
machinery at the runtime's own concurrent state machines — the paged
COW allocator, the scheduler × server loop, and the
speculate-commit-rewind cycle — and backs the abstract verdicts with a
conformance bridge to the real code:

* :mod:`~repro_torch.verify.models` — abstract models of the three state
  machines, each a one-process driver whose ``select`` branches over
  runtime operations (every transition names a real allocator method),
* :mod:`~repro_torch.verify.invariants` — the safety/liveness properties
  (``G p`` form, checked by exhaustive DFS),
* :mod:`~repro_torch.verify.conformance` — trail replay against the real
  :class:`~repro_torch.runtime.kv.PagedKVAllocator` (state agreement op
  by op) and the every-real-trace-is-a-model-path cross-check,
* :mod:`~repro_torch.verify.mutants` — deliberately broken allocators the
  checker must catch (the detector is itself tested),
* :mod:`~repro_torch.verify.lint` — AST rules codifying runtime hard-won
  lessons (host-aliasing at ``torch.from_numpy`` and dispatch, shared-pool
  writes, dict-order scheduling),
* ``python -m repro_torch.verify`` — the ``check`` / ``lint`` /
  ``replay`` / ``mutants`` CLI, a gate on the port's runtime.
"""

from .conformance import (ConformanceError, coupled_explore, ops_from_trail,
                          replay_ops, trace_accepted)
from .harness import (MiniServer, ServerConfig, ServerScenario, VReq,
                      canon_pages, restore_allocator)
from .invariants import (Invariant, allocator_invariants, server_invariants,
                         spec_invariants, violated, violates_any)
from .models import (AllocConfig, AllocatorSemantics, ServerSemantics,
                     SpecConfig, SpecSemantics, build_driver_model)
from .mutants import MUTANTS

__all__ = [
    "AllocConfig", "AllocatorSemantics", "SpecConfig", "SpecSemantics",
    "ServerConfig", "ServerScenario", "ServerSemantics", "MiniServer",
    "VReq", "canon_pages", "restore_allocator", "build_driver_model",
    "Invariant", "allocator_invariants", "server_invariants",
    "spec_invariants", "violated", "violates_any",
    "ConformanceError", "coupled_explore", "replay_ops", "trace_accepted",
    "ops_from_trail", "MUTANTS",
]
