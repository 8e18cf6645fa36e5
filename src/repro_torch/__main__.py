"""``python -m repro_torch``: the CLI front door (see repro_torch.api.cli)."""
import sys

from repro_torch.api.cli import main

if __name__ == "__main__":  # importing the module runs nothing
    sys.exit(main())
