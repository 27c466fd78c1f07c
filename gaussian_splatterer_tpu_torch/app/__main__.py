import sys

from gaussian_splatterer_tpu_torch.app.cli import main

sys.exit(main())
