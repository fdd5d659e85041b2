"""The card: whether there is one, its name and power limit, its memory
peak; the caches a run keeps inside its checkout; the modules a run must
not hold."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fedvit_tpu")


def require_cards(count: int) -> None:
    """Exit with code 2, printing no result, unless CUDA has ``count``
    cards. A run never falls back to the CPU."""
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < count:
        print(f"benchmark: the cell needs {count} cards, CUDA sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(2)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out


def device_record(count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def keep_caches_in(checkout: Path) -> None:
    """Point the build caches of torch and Triton at fixed directories of
    the checkout (the port's own kernels build into ``build/kernels/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(checkout / "build" / sub)


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
