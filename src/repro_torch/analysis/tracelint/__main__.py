import sys

from repro_torch.analysis.tracelint.cli import main

if __name__ == "__main__":
    sys.exit(main())
