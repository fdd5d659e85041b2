"""The serving loop's share of the card's bf16 peak: one forward's model
operations for every image whose logits reached the host in the measured
window, over the window's wall time and 989 TFLOP/s."""

from benchmark.harness import flops


def read(m):
    if m.images == 0 or m.wall_s <= 0:
        return None
    per_image = flops.forward_flops(m.arch, m.micro) / m.micro
    return 100.0 * per_image * m.images / m.wall_s / (
        m.cell.chips * flops.PEAK_BF16_FLOPS)
