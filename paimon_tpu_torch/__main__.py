"""`python -m paimon_tpu_torch` — the CLI entry point (see cli.py)."""

import sys

from paimon_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
