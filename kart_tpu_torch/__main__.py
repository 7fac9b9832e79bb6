"""``python -m kart_tpu_torch [-C PATH] [--device DEVICE] diff ...``"""

import sys

if __name__ == "__main__":
    # imported under the guard: a worker the import's fan-out spawns imports
    # this module again and needs none of the CLI (nor torch)
    from kart_tpu_torch.cli import main

    sys.exit(main())
