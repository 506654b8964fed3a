"""``python -m testground_tpu_torch``: the port's command line
(testground_tpu_torch/cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
