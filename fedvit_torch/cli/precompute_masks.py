"""Mask precompute CLI — the lesion masks of an ISIC-2019 directory, segmented
on the GPU.

    python -m fedvit_torch.cli.precompute_masks --isic_dir ./ISIC \
        --output_dir ./masks [--image_size 224] [--workers 8] [--batch 32] \
        [--device cuda]

The port of ``fedvit_tpu/cli/precompute_masks.py`` (the reference's
precompute_masks.py:168-202). Host threads decode each image with PIL at
twice the target size; ``ops/cvseg.py::segment_lesion_batch`` resizes and
segments them in device batches, each padded to ``--batch`` with its last
image so every batch has one shape; each mask is written as a PNG of 0 and
255 named after its image. The Training and Test input directories are
processed in turn, each skipped where it is absent. ``--device`` picks the
device, ``cuda`` by default; without a card the command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np


def collect_image_paths(image_dir: Path) -> List[Path]:
    """(reference precompute_masks.py:116-121)"""
    paths: List[Path] = []
    for ext in ("*.jpg", "*.jpeg", "*.png"):
        paths.extend(image_dir.glob(ext))
    return sorted(paths)


def _decode(path: Path, size: int) -> Optional[np.ndarray]:
    """(2·size, 2·size, 3) uint8, or None for a file PIL cannot read: the
    device's antialiased resize then does the area-style downscale."""
    from PIL import Image
    try:
        with Image.open(path) as im:
            im = im.convert("RGB").resize((size * 2, size * 2),
                                          Image.BILINEAR)
            return np.asarray(im, np.uint8)
    except Exception:   # noqa: BLE001 — an unreadable image is skipped
        return None


def precompute_masks(image_dir: Path, output_dir: Path, target_size: int,
                     workers: int, batch: int, device="cuda") -> int:
    """Segment every image of ``image_dir`` into ``output_dir``; returns the
    number of masks written."""
    import torch
    from PIL import Image

    from fedvit_torch.ops.cvseg import segment_lesion_batch
    from fedvit_torch.ops.image import div

    output_dir.mkdir(parents=True, exist_ok=True)
    paths = collect_image_paths(image_dir)
    if not paths:
        print(f"  No images found in {image_dir}")
        return 0
    print(f"  Found {len(paths)} images")

    count = skipped = 0
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for s in range(0, len(paths), batch):
            chunk = paths[s:s + batch]
            decoded = list(pool.map(lambda p: _decode(p, target_size), chunk))
            keep = [(p, d) for p, d in zip(chunk, decoded) if d is not None]
            skipped += len(chunk) - len(keep)
            if not keep:
                continue
            arr = np.stack([d for _, d in keep])
            n = len(keep)
            if n < batch:             # one shape for every batch
                arr = np.concatenate([arr, np.repeat(arr[-1:], batch - n, 0)])
            rgb = div(torch.from_numpy(arr).to(device).float(), 255.0)
            masks = segment_lesion_batch(rgb, target_size)[:n].cpu().numpy()
            for (p, _), m in zip(keep, masks):
                out = (m[..., 0] * 255).astype(np.uint8)
                Image.fromarray(out).save(output_dir / f"{p.stem}.png")
                count += 1
    if skipped:
        print(f"  Skipped {skipped} unreadable images")
    return count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Precompute lesion masks (classical CV, on the GPU)")
    parser.add_argument("--isic_dir", type=str, default="./ISIC")
    parser.add_argument("--output_dir", type=str, default="./masks")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--workers", type=int, default=8,
                        help="host decode threads")
    parser.add_argument("--batch", type=int, default=32,
                        help="device batch size")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from fedvit_torch.core.device import resolve_device
    device = resolve_device(args.device)

    isic_dir = Path(args.isic_dir)
    output_dir = Path(args.output_dir)
    for split_name, subdir in [("Training", "ISIC_2019_Training_Input"),
                               ("Test", "ISIC_2019_Test_Input")]:
        image_dir = isic_dir / subdir
        if not image_dir.exists():
            print(f"[{split_name}] Skipping – {image_dir} not found")
            continue
        print(f"\n[{split_name}] Processing images from {image_dir}")
        t0 = time.time()
        n = precompute_masks(image_dir, output_dir, args.image_size,
                             args.workers, args.batch, device)
        print(f"[{split_name}] Saved {n} masks → {output_dir} "
              f"({time.time() - t0:.1f}s)")
    print("\nDone!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
