"""`python -m arroyo_tpu_torch <cmd>`: the CLI (cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
