"""The serving attention kernel's share of its roofline: the least time the
attention of the profiled batches' forwards requires (``harness/flops.py``),
over the device time of the kernels that the configuration's family names
for serving (``ATTENTION_KERNELS["serve"]`` in ``families/<family>.py``;
ViT: K1, SwinV2: K5). None where no such kernel ran."""

from benchmark.harness import flops, manifest


def read(m):
    if m.profile is None or m.profiled_steps == 0:
        return None
    fam = manifest.family_module(m.arch["family"])
    seconds, names = m.profile.seconds(fam.ATTENTION_KERNELS["serve"])
    if names == 0 or seconds <= 0:
        return None
    least = flops.attention_least_seconds(m.arch, m.micro, ("serve",))
    return 100.0 * least * m.profiled_steps / seconds
