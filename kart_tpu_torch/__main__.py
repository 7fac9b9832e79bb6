"""``python -m kart_tpu_torch [-C PATH] [--device DEVICE] diff ...``"""

import sys

from kart_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
