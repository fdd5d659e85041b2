"""The benchmark's plain reference of the ISIC classifier and its training.

Plain PyTorch and NumPy only: it imports nothing of the program under test
and takes nothing the program made. The benchmark hands it the same raw
inputs it hands the program (canvases, metadata, labels, weights, seeds) and
it works everything else out again:

- ``models``: the configuration's backbone (its family's module in
  ``benchmark/families/``: timm-layout ViT or SwinV2) with a 4-channel patch
  embedding, the 13-dim metadata MLP and the classification head, written
  as functions of a dict of named tensors, in fp32 (or, for the control, in
  a lower precision);
- ``augment``: the train transform (crop, flips, rotation, jitter,
  RandAugment) and the eval transform, sample by sample in float64;
- ``train``: the mix, the asymmetric focal loss, the AdamW-LLRD update with
  its clip and schedule, and the EMA.
"""
