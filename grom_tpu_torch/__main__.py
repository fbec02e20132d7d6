import sys

from grom_tpu_torch.cli import main

sys.exit(main())
