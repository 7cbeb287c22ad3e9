"""`python -m go_avalanche_tpu_torch.analysis` entry point (see cli.py)."""

from go_avalanche_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
