"""Shared source/AST/annotation cache for the analysis gate.

Before this module, every pass opened, tokenized, and ``ast.parse``d
its target files independently — the runtime files the gate cares most
about (``serve/frontend.py``, ``shard/router.py``, ``net/peer.py``) are
each parsed by four to six passes per run.  ``SourceLoader`` does each
parse ONCE per gate run and hands every pass the same ``ParsedFile``
(source text + module AST + the parsed annotation set); the gate
records the hit/miss counts in ``ANALYSIS_REPORT_TORCH.json`` (``meta.
parse_cache``) so the win is adjudicated, not claimed.

Two deliberate properties:

* **Planted sources bypass the cache.**  Tests drive passes with
  ``analyze_file("<planted>", source=...)`` — same fake path, different
  source per test.  A ``load(path, source=...)`` call parses exactly
  what it was given and caches nothing, so a cached twin can never mask
  a planted violation.
* **The cache is per-run, not per-process.**  ``build_report`` creates
  one loader per gate run; a long-lived test process that edits files
  between runs never sees stale trees.  Passes called WITHOUT a loader
  (unit tests, ad-hoc use) construct a private one — the default is
  correctness, the shared instance is the optimization.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, NamedTuple, Optional

from go_crdt_playground_tpu_torch.analysis.annotations import (
    AnnotationSet, parse_annotations)


class ParsedFile(NamedTuple):
    path: str
    source: str
    tree: ast.Module
    annotations: AnnotationSet


class SourceLoader:
    """One gate run's parse cache, keyed by absolute path."""

    def __init__(self) -> None:
        self._cache: Dict[str, ParsedFile] = {}
        self.hits = 0
        self.misses = 0

    def load(self, path: str, source: Optional[str] = None) -> ParsedFile:
        """The parsed form of ``path``.  With ``source`` given, parse
        THAT text (planted-source test path) and skip the cache in both
        directions."""
        if source is not None:
            return ParsedFile(path, source,
                              ast.parse(source, filename=path),
                              parse_annotations(source, path))
        key = os.path.abspath(path)
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        with open(path) as f:
            text = f.read()
        pf = ParsedFile(path, text, ast.parse(text, filename=path),
                        parse_annotations(text, path))
        self._cache[key] = pf
        return pf

    def stats(self) -> Dict[str, int]:
        return {"files": len(self._cache), "hits": self.hits,
                "misses": self.misses}


def ensure_loader(loader: Optional[SourceLoader]) -> SourceLoader:
    """The pass-side entry point: share the gate's loader when given
    one, else a private single-use cache (same semantics, no sharing)."""
    return loader if loader is not None else SourceLoader()
