"""Build the hand-written CUDA kernels under ``fedvit_torch/csrc`` and load
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` (Hopper) into ``build/kernels/`` at the root of the
checkout, a directory ``.gitignore`` lists. The library's file name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and a finished build is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("qkvb_attention", "qkvb_attention_bwd",   # every csrc/<name>.cu
           "layer_norm_bwd", "layer_norm_fwd", "window_attention",
           "window_attention_bwd", "row_shift", "equalize", "xqkv_attention",
           "xqkv_attention_bwd", "rotary")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                           "to build the fedvit_torch kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is current.

    Returns the compiler's output (the ``-Xptxas -v`` register and
    shared-memory report), or "" if nothing was compiled; raises with the
    compiler's output if the build fails."""
    lib = library_path(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half a file
    return proc.stdout


def build_all() -> Dict[str, str]:
    """Build every source at once, one ``nvcc`` each, all started together;
    returns each one's compiler output (see ``build``)."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
