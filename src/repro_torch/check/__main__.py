import sys

from repro_torch.check.runner import main

if __name__ == "__main__":
    sys.exit(main())
