#!/usr/bin/env python
"""Path-free entry point for the PyTorch port's dataplane contract checker.

Equivalent to ``PYTHONPATH=src python -m repro_torch.analysis.contracts``
but runnable from anywhere inside the repo without environment setup, on
any machine with torch, with a card or without one:

    python tools/check_contracts_torch.py

See ``src/repro_torch/analysis/contracts.py``.
"""

from __future__ import annotations

import os
import sys

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(_REPO, "src"))

from repro_torch.analysis.contracts import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
