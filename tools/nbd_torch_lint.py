#!/usr/bin/env python
"""Checkout-local launcher for ``nbd-torch-lint`` (the console script
ships via pyproject; in a raw checkout run this file:
``python tools/nbd_torch_lint.py --self``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from nbdistributed_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
