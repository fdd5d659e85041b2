"""The serving attention kernel's share of its roofline: the least time the
attention of the profiled batches' forwards requires (``harness/flops.py``),
over the device time of the kernels that match these names. ViT: K1;
SwinV2: K5. None where no such kernel ran."""

from benchmark.harness import flops

PATTERNS = {
    "vit": (r"attn_fwd::fwd_kernel<[^>]*, true, false>",),
    "swinv2": (r"window_mma_fwd_kernel<false, false, ",),
}


def read(m):
    if m.profile is None or m.profiled_steps == 0:
        return None
    seconds, names = m.profile.seconds(PATTERNS[m.arch["family"]])
    if names == 0 or seconds <= 0:
        return None
    least = flops.attention_least_seconds(m.arch, m.micro, ("serve",))
    return 100.0 * least * m.profiled_steps / seconds
