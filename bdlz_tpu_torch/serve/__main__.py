"""``python -m bdlz_tpu_torch.serve`` → the serving CLI."""
import sys

from bdlz_tpu_torch.serve.serve_cli import main

if __name__ == "__main__":
    sys.exit(main())
