"""Finding/report plumbing shared by every analyzer pass.

A ``Finding`` is one diagnostic: pass name, severity, location, message,
and an optional stable ``code`` (the grep-able contract — tests pin
codes, not message prose).  ``Report`` aggregates per-pass findings plus
pass-level stats into the ``ANALYSIS_REPORT_TORCH.json`` shape documented in
DESIGN.md §15.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

SEVERITY_ERROR = "error"      # gate-failing: the invariant is violated
SEVERITY_WARNING = "warning"  # suspicious but not gate-failing

# Stable finding codes (tests and DESIGN.md §15 pin these):
UNGUARDED_ACCESS = "L001"       # guarded field touched without its lock
LOCK_ORDER_CYCLE = "L002"       # lock acquisition graph has a cycle
UNANNOTATED_SHARED = "L003"     # field locked sometimes, annotated never
RACE_EMPTY_LOCKSET = "R001"     # runtime: shared write, empty lockset
FSYNC_MISSING = "D001"          # ack/rename not dominated by fsync
PURITY_VIOLATION = "P001"       # host side effect in kernel-reachable code
LAW_COMMUTATIVITY = "J001"
LAW_ASSOCIATIVITY = "J002"
LAW_IDEMPOTENCE = "J003"
LAW_DECLARATION = "J004"        # JoinSpec.laws empty or unknown
# wire-contract passes (analysis/protocol_contract.py,
# analysis/codec_symmetry.py, analysis/metrics_contract.py):
DISPATCH_HOLE = "W001"          # MSG_* constant with no dispatcher arm
REJECT_UNDISCIPLINED = "W002"   # reject code/exception registry drift
CODEC_ASYMMETRY = "W003"        # encode/decode pair broke its contract
FRAME_CAP_MISSING = "W004"      # recv_frame call site without max_body
METRICS_CONTRACT = "M001"       # metric name referenced/emitted drift
REPORT_STALE = "F001"           # committed report's pass list is stale
THREAD_SHADOW = "T001"          # Thread subclass shadows a Thread internal
# protocol-verification ladder (analysis/protomodel.py,
# analysis/epoch_order.py, analysis/fence_coverage.py,
# analysis/transfer_lock.py — DESIGN.md §26):
EPOCH_ORDER = "E001"            # persist does not dominate announce/bind
FENCE_UNCOVERED = "E002"        # write-verb arm consults no fence predicate
MODEL_STALE = "E003"            # protocol model drifted from its source
MODEL_VIOLATION = "E004"        # explorer found an invariant-violating run
TRANSFER_UNDER_LOCK = "D002"    # blocking device transfer while lock held


@dataclass
class Finding:
    analyzer: str                 # "lockdiscipline" | "locksets" | ...
    code: str
    severity: str
    message: str
    path: Optional[str] = None
    line: Optional[int] = None
    symbol: Optional[str] = None  # class.field / function / join name

    def location(self) -> str:
        loc = self.path or "<runtime>"
        if self.line is not None:
            loc += f":{self.line}"
        return loc

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.severity.upper()} {self.code} "
                f"{self.location()}{sym}: {self.message}")


@dataclass
class Report:
    """One gate run: per-pass findings + stats, JSON-serializable."""

    findings: List[Finding] = field(default_factory=list)
    stats: Dict[str, Dict] = field(default_factory=dict)
    # run-level metadata (wall time, parse-cache hit rates, budgets) —
    # serialized top-level, NOT as a pass: the report-freshness lint
    # compares pass lists, and meta must never read as coverage
    meta: Dict = field(default_factory=dict)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    def add_stats(self, analyzer: str, **stats) -> None:
        self.stats.setdefault(analyzer, {}).update(stats)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_ERROR]

    def ok(self) -> bool:
        return not self.errors()

    def to_dict(self) -> Dict:
        by_pass: Dict[str, List[Dict]] = {}
        for f in self.findings:
            by_pass.setdefault(f.analyzer, []).append(asdict(f))
        return {
            "ok": self.ok(),
            "n_findings": len(self.findings),
            "n_errors": len(self.errors()),
            "meta": dict(self.meta),
            "passes": {
                name: {
                    "stats": self.stats.get(name, {}),
                    "findings": by_pass.get(name, []),
                }
                # every pass appears even when clean — "covered and
                # found nothing" must be distinguishable from "not run"
                for name in sorted(set(self.stats) | set(by_pass))
            },
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
