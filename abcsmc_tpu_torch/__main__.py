"""``python -m abcsmc_tpu_torch``: the command-line interface
(:mod:`abcsmc_tpu_torch.cli`)."""

import sys

from abcsmc_tpu_torch.cli import main

sys.exit(main())
