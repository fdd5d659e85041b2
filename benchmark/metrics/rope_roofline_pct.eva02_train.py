"""The rotary kernel's share of its roofline in EVA-02-L training: the bytes
of every rotation of the profiled steps (q and k of the patch tokens read
and written once and the table read, a block of each forward and each
backward: ``families/eva02.py::rope_calls``) over 3.35 TB/s, against the
device time of the kernels named ``rotary_kernel<``
(``fedvit_torch/csrc/rotary.cu``). None where no such kernel ran (a program
that turns q and k by plain PyTorch) or the family counts no rotation."""

from benchmark.harness import flops, manifest

PATTERNS = (r"\brotary_kernel<",)


def read(m):
    if m.profile is None or not m.profiled_steps:
        return None
    calls = getattr(manifest.family_module(m.arch["family"]), "rope_calls",
                    None)
    seconds, names = m.profile.seconds(PATTERNS)
    if calls is None or names == 0 or seconds <= 0:
        return None
    least = sum(flops.least_seconds(b, f)
                for kind in ("train_fwd", "train_bwd")
                for b, f in calls(m.arch, m.micro, kind))
    return 100.0 * least * m.accum * m.profiled_steps / seconds
