"""``python -m repro_torch.tune``: entry point shim for the autotuning
CLI; the implementation lives in :mod:`repro_torch.launch.tune`.
"""
import sys

from repro_torch.launch.tune import main

if __name__ == "__main__":
    sys.exit(main())
