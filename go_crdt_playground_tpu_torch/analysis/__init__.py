"""Invariant analyzer suite: the correctness tooling the runtime grew to
need (DESIGN.md §15).

Three invariant classes in this stack were, until this package, probed
only dynamically by soaks:

* **lock discipline** in the threaded anti-entropy runtime (the Node
  lock serializing state/WAL, the ``_conn_slots`` semaphore, supervisor
  threads) — the sync runtime carries ``# guarded-by:`` contracts in
  comments;
* **durability ordering** in the WAL/checkpoint layer — fsync must
  dominate every ack/rename, or "durable on return" is a lie the next
  power cut exposes;
* **lattice laws** — commutativity, associativity, idempotence are what
  make the vmapped merge a join at all (Almeida et al.,
  arXiv:1410.2803; Enes et al., arXiv:1803.02750); a non-commutative
  "join" converges only on the schedules the tests happened to run.

Four passes, one gate:

    python -m go_crdt_playground_tpu_torch.analysis          # full gate
    python -m go_crdt_playground_tpu_torch.analysis --fast   # tier-1 budget

``lockdiscipline``  AST lint over ``# guarded-by:`` / ``# requires-lock:``
                    annotations plus a lock-order cycle check.
``locksets``        Eraser-style runtime lockset race detector
                    (instrumented locks + attribute tracing); opt-in
                    under the soaks via ``--detect-races`` and embedded
                    as a short exercise in the CLI gate.
``durability``      fsync-dominates-ack/rename lint + kernel-purity lint
                    for the plain versions and the ctypes launchers
                    (``purity``).
``lattice_laws``    randomized, seeded property checks of every join in
                    the ``ops.lattices`` registry.

Each pass returns a list of ``report.Finding``; the CLI aggregates them
into ``ANALYSIS_REPORT_TORCH.json`` and exits non-zero on any ERROR finding.
"""

from go_crdt_playground_tpu_torch.analysis.report import (
    Finding, Report, SEVERITY_ERROR, SEVERITY_WARNING)

__all__ = [
    "Finding",
    "Report",
    "SEVERITY_ERROR",
    "SEVERITY_WARNING",
]
