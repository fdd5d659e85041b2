"""The inputs made from the seed: lesion-like canvases of the same sizes for
every seed, the same canvases from the same seed."""

import pytest
import torch

from benchmark.harness import inputs

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 3 * 10 ** 9 + 17])
def test_canvases_are_lesions_on_skin_with_their_mask(seed):
    c = inputs.make_canvases(40, 64, seed, CPU)
    assert c.shape == (40, 64, 64, 4) and c.dtype == torch.uint8
    assert torch.equal(c, inputs.make_canvases(40, 64, seed, CPU))
    mask = c[..., 3]
    assert set(mask.unique().tolist()) == {0, 255}
    inside = (mask > 0).float()
    share = inside.mean((1, 2))
    assert (share > 0.01).all() and (share < 0.9).all()
    luma = c[..., :3].float().mean(-1)
    lesion = (luma * inside).sum((1, 2)) / inside.sum((1, 2))
    skin = (luma * (1 - inside)).sum((1, 2)) / (1 - inside).sum((1, 2))
    assert (lesion < 0.8 * skin).all()


def test_the_first_canvases_alone_are_the_same():
    whole = inputs.make_canvases(300, 32, 5, CPU)
    assert torch.equal(inputs.make_canvases(300, 32, 5, CPU, first=260),
                       whole[:260])


def test_the_intensities_crowd_into_few_bins():
    """Unlike uniform bytes, a canvas's red channel puts a good share of its
    pixels into its ten fullest intensity bins."""
    c = inputs.make_canvases(8, 96, 11, CPU)
    for img in c[..., 0]:
        h = torch.bincount(img.flatten(), minlength=256).sort(descending=True)
        assert h.values[:10].sum() > 0.08 * img.numel()
