"""The training step's share of the cards' bf16 peak: the model operations
the configuration's shapes require for every image trained in the measured
window (three forwards an image, ``harness/flops.py``), over the window's
wall time and the cards' 989 TFLOP/s."""

from benchmark.harness import flops


def read(m):
    if m.images == 0 or m.wall_s <= 0:
        return None
    per_image = flops.train_flops(m.arch, m.micro) / m.micro
    return 100.0 * per_image * m.images / m.wall_s / (
        m.cell.chips * flops.PEAK_BF16_FLOPS)
