"""Example: grep a file (the reference's examples/grep.rs), on the card.

    python -m sliceslice_tpu_torch.examples.grep dynamic "Protected Mode" data/i386.txt
"""

import sys

from sliceslice_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
