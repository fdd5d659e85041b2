"""The LayerNorm forward kernel's device ms a training step: the device time of
the operations named ``ln_fwd_kernel<``
(``fedvit_torch/csrc/layer_norm_fwd.cu``) in the profiled steps, over the
profiled steps. The name matches no pattern of ``attn_roofline_pct.*``. None
where no such kernel ran (a program whose LayerNorm forward is plain
PyTorch)."""

PATTERNS = (r"\bln_fwd_kernel<",)


def read(m):
    if m.profile is None or not m.profiled_steps:
        return None
    seconds, names = m.profile.seconds(PATTERNS)
    if names == 0:
        return None
    return 1e3 * seconds / m.profiled_steps
