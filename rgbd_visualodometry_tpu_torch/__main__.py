"""``python -m rgbd_visualodometry_tpu_torch <config.yaml>``: the CLI."""

import sys

from rgbd_visualodometry_tpu_torch.cli import main

sys.exit(main())
