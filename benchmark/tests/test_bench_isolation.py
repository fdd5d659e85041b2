"""What a run imports: no JAX, no JAX package, and a reference (with the
families' modules, which are reference code) that loads nothing of the
program. Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from benchmark.harness.device import FORBIDDEN
from benchmark.harness.manifest import BENCH_DIR, REPO_DIR

HARNESS = ("benchmark.run", "benchmark.calibrate", "benchmark.harness.checks",
           "benchmark.harness.device", "benchmark.harness.flops",
           "benchmark.harness.inputs", "benchmark.harness.manifest",
           "benchmark.harness.program", "benchmark.harness.report",
           "benchmark.harness.trace")
REFERENCE = ("benchmark.reference", "benchmark.reference.models",
             "benchmark.reference.augment", "benchmark.reference.train")
FAMILIES = sorted((BENCH_DIR / "families").glob("*.py"))
# what the modes import from the program when a run builds it
PROGRAM = ("fedvit_torch.core.config", "fedvit_torch.core.kernels",
           "fedvit_torch.data.pipeline", "fedvit_torch.eval.serve",
           "fedvit_torch.models", "fedvit_torch.train.loop",
           "fedvit_torch.train.losses", "fedvit_torch.train.optim",
           "fedvit_torch.train.state", "fedvit_torch.train.step")


def loaded_after(modules, files=()):
    """The top-level names of every module loaded in a fresh interpreter
    after importing ``modules`` and loading ``files`` by path."""
    code = f"""
import importlib, importlib.util, json, sys
sys.path.insert(0, {str(REPO_DIR)!r})
for m in {list(modules)!r}:
    importlib.import_module(m)
for i, f in enumerate({[str(f) for f in files]!r}):
    spec = importlib.util.spec_from_file_location(f"bench_file_{{i}}", f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    files = sorted((BENCH_DIR / "modes").glob("*.py")) + \
        sorted((BENCH_DIR / "metrics").glob("*.py")) + FAMILIES
    names = loaded_after(HARNESS + REFERENCE + PROGRAM, files)
    assert "fedvit_torch" in names and "torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after(REFERENCE, FAMILIES)
    assert "fedvit_torch" not in names
    assert not names & set(FORBIDDEN)


def test_the_names_are_compared_whole():
    """``fedvit_torch`` begins with ``fedvit_t`` but is not ``fedvit_tpu``."""
    from benchmark.harness import device
    sys.modules.setdefault("fedvit_tpu_lookalike", sys)
    try:
        assert "fedvit_tpu_lookalike" not in device.forbidden_modules()
    finally:
        del sys.modules["fedvit_tpu_lookalike"]
