import sys

from amaranth_twstft_tpu_torch.cli import main

sys.exit(main())
