"""``python -m mano_hand_tpu_torch``: the port's command line (cli.py)."""

import sys

from mano_hand_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
