"""The ragged LayerNorm kernels' device ms a training step: the device time
of the operations named ``ln_fwd_ragged_kernel<`` and
``ln_bwd_ragged_kernel<`` (``fedvit_torch/csrc/layer_norm_fwd.cu``,
``layer_norm_bwd.cu``: rows whose size is not a multiple of 16 bytes, such
as EVA-02-L's SwiGLU norm at D 2,730) in the profiled steps, over the
profiled steps. K4's column pass, which the ragged backward shares with the
16-byte one, is not counted. None where no such kernel ran."""

PATTERNS = (r"\bln_fwd_ragged_kernel<", r"\bln_bwd_ragged_kernel<")


def read(m):
    if m.profile is None or not m.profiled_steps:
        return None
    seconds, names = m.profile.seconds(PATTERNS)
    if names == 0:
        return None
    return 1e3 * seconds / m.profiled_steps
