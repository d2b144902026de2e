#!/usr/bin/env python
"""Repo-root wrapper for the port's analysis gate.

    python tools/torch_analyze.py [--fast] [--device cpu] [--out PATH]

Identical to ``python -m go_crdt_playground_tpu_torch.analysis`` — this
wrapper only adds the repo root to ``sys.path`` (the pattern the soak
tools use) and defaults the report to ``ANALYSIS_REPORT_TORCH.json`` at
the repo root.  ``--device`` defaults to ``cuda`` and raises without a
GPU, as every port entry does.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

if __name__ == "__main__":
    from go_crdt_playground_tpu_torch.analysis.__main__ import main

    argv = sys.argv[1:]
    if not any(a.startswith("--out") for a in argv):
        argv += ["--out", os.path.join(REPO, "ANALYSIS_REPORT_TORCH.json")]
    sys.exit(main(argv))
