"""The training attention kernels' share of their roofline: the least time
the attention of the profiled steps requires (each forward under grad and
each backward, block by block, from the configuration's shapes:
``harness/flops.py``), over the device time of the kernels that match these
names. ViT: K2 (the forward with its log-sum-exp) and K3; SwinV2: K5's
log-sum-exp entry and K6. None where no such kernel ran."""

from benchmark.harness import flops

PATTERNS = {
    "vit": (r"attn_fwd::fwd_kernel<[^>]*, true, true>",
            r"attn_bwd::delta_kernel<",
            r"attn_bwd::(dkdv|dq)(_mma)?_kernel<[^>]*, true, true>",
            r"column_sum_kernel<"),
    "swinv2": (r"window_mma_fwd_kernel<true, false, ",
               r"(?<!attn_bwd::)\b(delta|dkdv_mma|dq_mma|dbias_mma)_kernel\b"),
}


def read(m):
    if m.profile is None or m.profiled_steps == 0:
        return None
    seconds, names = m.profile.seconds(PATTERNS[m.arch["family"]])
    if names == 0 or seconds <= 0:
        return None
    least = flops.attention_least_seconds(m.arch, m.micro,
                                          ("train_fwd", "train_bwd"))
    return 100.0 * least * m.accum * m.profiled_steps / seconds
