"""The training attention kernels' share of their roofline: the least time
the attention of the profiled steps requires (each forward under grad and
each backward, block by block, from the configuration's shapes:
``harness/flops.py``), over the device time of the kernels that the
configuration's family names for training (``ATTENTION_KERNELS["train"]``
in ``families/<family>.py``; ViT: K2, the forward with its log-sum-exp, and
K3; SwinV2: K5's log-sum-exp entry and K6). None where no such kernel ran."""

from benchmark.harness import flops, manifest


def read(m):
    if m.profile is None or m.profiled_steps == 0:
        return None
    fam = manifest.family_module(m.arch["family"])
    seconds, names = m.profile.seconds(fam.ATTENTION_KERNELS["train"])
    if names == 0 or seconds <= 0:
        return None
    least = flops.attention_least_seconds(m.arch, m.micro,
                                          ("train_fwd", "train_bwd"))
    return 100.0 * least * m.accum * m.profiled_steps / seconds
