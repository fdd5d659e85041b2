"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests``."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

# the tests' tiny models are small products: several workers, each with a
# full thread pool, would only contend for the cores
torch.set_num_threads(2)
