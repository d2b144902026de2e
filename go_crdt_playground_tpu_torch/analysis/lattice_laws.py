"""Lattice-law checker: the joins must actually be joins.

Commutativity, associativity, and idempotence are the load-bearing
assumptions of the whole stack: they are why a lost exchange is only
delayed convergence (SURVEY §5.3), why WAL replay after a crash is
harmless double-merge (DESIGN.md §14), and why the δ-CRDT literature can
ship fragments instead of states (Almeida et al., arXiv:1410.2803).  A
"join" that quietly violates one converges only on the schedules the
tests happened to run — the worst kind of latent bug.

This pass enumerates ``ops.lattices.JOIN_REGISTRY`` (which
``ops.merge`` extends with the AWSet merge) and, per family:

* samples batched REACHABLE states with the family's seeded sampler
  (random ops + gossip mixing — the laws are promised over reachable
  states, not arbitrary bit patterns);
* builds row-wise triples (a, b, c) via seeded row permutations of the
  sample (so operands share causal history, the interesting regime);
* checks, on the family's observable projection:
      commutativity   join(a, b) == join(b, a)
      associativity   join(join(a, b), c) == join(a, join(b, c))
      idempotence     join(a, a) == a
* reports the first counterexample row per (family, law, seed) with the
  differing field (J001/J002/J003, gate-failing).

Everything is seeded and small (rows ~9, ops ~40 per seed), and runs
on the gate's device: on the card the AWSet and OR-Map joins run on K2
(``cuda_merge.merge_pairwise_rows``).  The ``--fast`` gate trims seeds,
not families — every registered join is checked on every run.  The
OR-Map join is the port's per-row join (the reference's, applied to a
batch outside ``vmap``, reads row 0's clock for every row).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from go_crdt_playground_tpu_torch.analysis.report import (
    LAW_ASSOCIATIVITY, LAW_COMMUTATIVITY, LAW_DECLARATION, LAW_IDEMPOTENCE,
    SEVERITY_ERROR, Finding)

_LAW_CODES = {
    "commutativity": LAW_COMMUTATIVITY,
    "associativity": LAW_ASSOCIATIVITY,
    "idempotence": LAW_IDEMPOTENCE,
}


def _diff_rows(pa: Dict[str, np.ndarray],
               pb: Dict[str, np.ndarray],
               atol: float = 0.0) -> Optional[Tuple[int, str]]:
    """(row, field) of the first mismatch between two projections.
    ``atol`` > 0 compares float fields with an absolute tolerance —
    for joins whose declared laws hold only up to IEEE rounding (the
    weighted-mean accumulator's associativity); integer/bool fields
    stay exact either way."""
    for field in pa:
        a, b = pa[field], pb[field]
        if a.shape != b.shape:
            return 0, field
        if atol > 0 and np.issubdtype(a.dtype, np.floating):
            neq = ~np.isclose(a, b, rtol=0.0, atol=atol)
        else:
            neq = a != b
        if neq.ndim > 1:
            neq = neq.reshape(neq.shape[0], -1).any(axis=1)
        if neq.any():
            return int(np.argmax(neq)), field
    return None


def _permuted(state, rng: np.random.Generator):
    """Every tensor of the state tuple indexed by one row permutation."""
    import torch

    n = int(state[0].shape[0])
    perm = torch.from_numpy(np.asarray(rng.permutation(n), np.int64))
    perm = perm.to(state[0].device)
    return type(state)(*(x[perm] for x in state))


def check_join_spec(spec, seeds: Sequence[int], *, n_rows: int = 9,
                    n_ops: int = 40, device="cuda"
                    ) -> Tuple[List[Finding], Dict]:
    """Property-check one JoinSpec over its DECLARED law subset
    (``JoinSpec.laws`` — the model-merging strategies claim fewer laws
    than a lattice join, with the why on record in ops/lattices.py);
    returns (findings, stats).  A spec claiming no laws at all is an
    error, not a skip — "registered but unchecked" must be
    impossible."""
    findings: List[Finding] = []
    checked = 0
    laws = tuple(getattr(spec, "laws", tuple(_LAW_CODES)))
    atol = float(getattr(spec, "atol", 0.0))
    unknown = [law for law in laws if law not in _LAW_CODES]
    if unknown or not laws:
        findings.append(Finding(
            analyzer="lattice_laws", code=LAW_DECLARATION,
            severity=SEVERITY_ERROR, symbol=spec.name,
            message=(f"join {spec.name!r} declares an invalid law "
                     f"subset {laws!r} (unknown: {unknown}) — every "
                     "registered join must claim at least one known "
                     "law")))
        return findings, {"seeds": list(seeds), "laws_checked": 0,
                          "laws": list(laws), "n_rows": n_rows,
                          "n_ops": n_ops}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        base = spec.sample(rng, n_rows, n_ops, device=device)
        a = base
        b = _permuted(base, rng)
        c = _permuted(base, rng)
        join, project = spec.join, spec.project

        cases = (
            ("commutativity", lambda: (join(a, b), join(b, a))),
            ("associativity", lambda: (join(join(a, b), c),
                                       join(a, join(b, c)))),
            ("idempotence", lambda: (join(a, a), a)),
        )
        for law, make in cases:
            if law not in laws:
                continue
            lhs, rhs = make()
            checked += 1
            # commutativity is checked on the SYMMETRIC part of the
            # projection: fields the join defines as dst-anchored
            # (none today) would be excluded by the spec's project()
            diff = _diff_rows(project(lhs), project(rhs), atol)
            if diff is not None:
                row, field = diff
                findings.append(Finding(
                    analyzer="lattice_laws", code=_LAW_CODES[law],
                    severity=SEVERITY_ERROR, symbol=spec.name,
                    message=(f"{law} counterexample for join "
                             f"{spec.name!r}: field {field!r} differs at "
                             f"row {row} (seed {seed}, n_rows {n_rows}, "
                             f"n_ops {n_ops}) — this join does not "
                             "satisfy its declared laws over reachable "
                             "states")))
                break  # further laws on a broken join add noise
    return findings, {"seeds": list(seeds), "laws_checked": checked,
                      "laws": list(laws), "n_rows": n_rows,
                      "n_ops": n_ops}


def check_registry(seeds: Sequence[int] = (11, 12, 13), *,
                   n_rows: int = 9, n_ops: int = 40,
                   registry: Optional[Dict] = None, device="cuda"
                   ) -> Tuple[List[Finding], Dict]:
    """Check every registered join (importing ops.merge first so its
    registration has run), sampled and joined on ``device``."""
    from go_crdt_playground_tpu_torch.ops import lattices
    from go_crdt_playground_tpu_torch.ops import merge  # noqa: F401

    reg = lattices.JOIN_REGISTRY if registry is None else registry
    findings: List[Finding] = []
    stats: Dict = {"families": sorted(reg), "per_family": {},
                   "laws_by_family": {}}
    for name in sorted(reg):
        f, s = check_join_spec(reg[name], seeds, n_rows=n_rows,
                               n_ops=n_ops, device=device)
        findings.extend(f)
        stats["per_family"][name] = s["laws_checked"]
        stats["laws_by_family"][name] = s["laws"]
    return findings, stats
