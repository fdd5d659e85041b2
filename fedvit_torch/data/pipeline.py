"""Input pipeline — host decode to a fixed uint8 canvas, then the augmentation
on the device (``fedvit_tpu/data/pipeline.py``).

    host:    image file → RGB canvas (canvas_size(image_size))², uint8,
             plus the mask PNG as a 4th channel when masks are fed; a
             background thread keeps ``data.prefetch_batches`` batches ahead,
             and ``data.cache_gb`` bounds the cache of decoded canvases
    device:  make_device_augment(cfg, train): the lesion mask segmented
             from a 3-channel canvas when ``data.on_device_masks`` is set
             (ops/cvseg.py), then the train transform
             (ops/image.py::train_transform — crop, flips, rotation, jitter,
             RandAugment, normalize) or the eval transform (resize to
             1.14·size, centre crop, normalize)

A dataset that fits ``data.device_resident_mb`` is uploaded to the card once
(``DeviceDataSource``) and its batches gathered there from index plans.
Every source's gather of a batch is the span ``data.gather``
(``utils/profiling.py``).

PIL and pandas are imported where files are read, so the rest of the port
runs without them.
"""

from __future__ import annotations

import math
import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from fedvit_torch.core.config import Config
from fedvit_torch.data.constants import encode_metadata_batch
from fedvit_torch.data.sampling import epoch_indices
from fedvit_torch.ops import image as I
from fedvit_torch.ops.cvseg import segment_lesion_batch
from fedvit_torch.utils.profiling import span


def canvas_size(image_size: int) -> int:
    """Smallest multiple of 16 ≥ 1.15·image_size (covers the eval resize at
    1.14·size without a second host decode)."""
    return int(math.ceil(image_size * 1.15 / 16) * 16)


def _load_image(path: str, canvas: int) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB").resize((canvas, canvas), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def _load_mask(path: Path, canvas: int) -> Optional[np.ndarray]:
    from PIL import Image
    if not path.exists():
        return None
    with Image.open(path) as im:
        im = im.convert("L").resize((canvas, canvas), Image.NEAREST)
        return np.asarray(im, dtype=np.uint8)[..., None]


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` in a background thread, keeping up to ``depth`` items
    ahead — overlaps host batch assembly with device compute (the reference
    gets this from DataLoader workers, data.py:466-473). Order-preserving;
    producer exceptions re-raise at the consumer. An abandoned consumer
    (break, exception, or the generator closed) unblocks the producer through
    a stop flag checked around each bounded put."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(msg) -> bool:
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for x in it:
                if not _put(("item", x)):
                    return
            _put(("end", None))
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            _put(("err", e))

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            tag, payload = q.get()
            if tag == "end":
                return
            if tag == "err":
                raise payload
            yield payload
    finally:
        stop.set()


class _ByteLRU:
    """Byte-budgeted LRU over decoded canvases (the dict subset
    HostDataSource uses), safe across its decode threads."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.used = 0
        self._d: OrderedDict[int, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, k: int) -> Optional[np.ndarray]:
        """The cached array or None; never raises on a concurrent
        eviction."""
        with self._lock:
            v = self._d.get(k)
            if v is not None:
                self._d.move_to_end(k)
            return v

    def __setitem__(self, k: int, v: np.ndarray) -> None:
        with self._lock:
            if k in self._d:
                self._d.move_to_end(k)
                return
            self._d[k] = v
            self.used += v.nbytes
            while self.used > self.budget and len(self._d) > 1:
                _, old = self._d.popitem(last=False)
                self.used -= old.nbytes


class HostDataSource:
    """Decodes a dataframe's images (and masks) to fixed-canvas uint8 arrays
    with a thread pool, caching decoded canvases in RAM: all of them, or
    ``data.cache_gb`` of them, least recently used first out. The dataframe
    has ``image_path`` and ``label`` columns, ``image`` names the mask PNG,
    and ``age_norm``/``sex_idx``/``site_idx`` default to unknown. Under
    ``data.on_device_masks`` no mask is read: the canvases have 3 channels
    and the device augment segments them."""

    def __init__(self, df, cfg: Config):
        self.df = df.reset_index(drop=True)
        self.canvas = canvas_size(cfg.model.image_size)
        self.mask_dir = (Path(cfg.data.segmentation_mask_dir)
                         if cfg.data.use_segmentation_mask
                         and not cfg.data.on_device_masks else None)
        self.workers = max(1, cfg.training.num_workers)
        self.labels = self.df["label"].to_numpy(dtype=np.int32)
        n = len(self.df)

        def col(name, default):
            return (self.df[name].to_numpy() if name in self.df
                    else np.full(n, default))

        self.metadata = encode_metadata_batch(
            col("age_norm", 0.5), col("sex_idx", 2), col("site_idx", 8))
        self._cache = (_ByteLRU(int(cfg.data.cache_gb * 2 ** 30))
                       if cfg.data.cache_gb and cfg.data.cache_gb > 0 else {})
        self.prefetch = cfg.data.prefetch_batches

    def __len__(self):
        return len(self.df)

    def _fetch_one(self, i: int) -> np.ndarray:
        hit = self._cache.get(i)
        if hit is not None:
            return hit
        img = _load_image(self.df["image_path"].iloc[i], self.canvas)
        if self.mask_dir is not None:
            m = _load_mask(self.mask_dir / f"{self.df['image'].iloc[i]}.png",
                           self.canvas)
            if m is None:
                m = np.zeros((self.canvas, self.canvas, 1), np.uint8)
            img = np.concatenate([img, m], axis=-1)
        self._cache[i] = img
        return img

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """{"image" (B, canvas, canvas, 3|4) uint8, "label", "metadata"}."""
        idx = np.asarray(indices).reshape(-1)
        with span("data.gather"):
            with ThreadPoolExecutor(self.workers) as pool:
                imgs = list(pool.map(self._fetch_one, idx.tolist()))
            return {"image": np.stack(imgs), "label": self.labels[idx],
                    "metadata": self.metadata[idx]}

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      weighted: bool, drop_last: bool = True
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch's batches in the order of ``epoch_indices``, decoded
        ``prefetch_batches`` ahead in a background thread."""
        plan = epoch_indices(self.labels, batch_size, rng, weighted=weighted,
                             drop_last=drop_last)
        return prefetch_iterator((self.gather(row) for row in plan),
                                 self.prefetch)

    def sequential_batches(self, batch_size: int
                           ) -> Iterator[Dict[str, np.ndarray]]:
        return prefetch_iterator(
            (self.gather(np.arange(s, min(s + batch_size, len(self))))
             for s in range(0, len(self), batch_size)), self.prefetch)


class ArrayDataSource:
    """HostDataSource-compatible source over in-memory arrays (synthetic
    fixtures, pre-decoded datasets), as ``fedvit_tpu``'s. data: {"image"
    (N, H, W, 3|4) uint8 canvases or [0, 1] floats (stored as uint8
    canvases, as JAX's are), the mask as the 4th channel; "label" (N,);
    "metadata" (N, 13)}."""

    def __init__(self, data: Dict[str, np.ndarray]):
        img = np.asarray(data["image"])
        if img.dtype != np.uint8:       # clipped, scaled by 255, truncated
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self.images = img
        self.labels = np.asarray(data["label"], np.int32)
        self.metadata = np.asarray(data["metadata"], np.float32)
        self.canvas = img.shape[1]

    def __len__(self):
        return len(self.labels)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        with span("data.gather"):
            idx = np.asarray(indices).reshape(-1)
            return {"image": self.images[idx], "label": self.labels[idx],
                    "metadata": self.metadata[idx]}

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      weighted: bool, drop_last: bool = True
                      ) -> Iterator[Dict[str, np.ndarray]]:
        plan = epoch_indices(self.labels, batch_size, rng, weighted=weighted,
                             drop_last=drop_last)
        for row in plan:
            yield self.gather(row)

    def sequential_batches(self, batch_size: int
                           ) -> Iterator[Dict[str, np.ndarray]]:
        for s in range(0, len(self), batch_size):
            yield self.gather(np.arange(s, min(s + batch_size, len(self))))


class DeviceDataSource:
    """A source whose decoded canvases live on the device: uploaded once,
    chunk by chunk into one preallocated uint8 tensor, and gathered there
    from index plans. Batches come out as dicts of tensors on the device;
    ``labels`` and ``metadata`` stay on the host too, for the sampler and
    the metrics. It removes every per-step host-to-device copy of images."""

    CHUNK = 2048      # decode and upload granularity (bounds host transients)

    def __init__(self, source, device):
        self.device = torch.device(device)
        n = len(source)
        first = source.gather(np.arange(min(self.CHUNK, n)))
        self.canvas = int(first["image"].shape[1])
        self.images = torch.empty((n,) + tuple(first["image"].shape[1:]),
                                  dtype=torch.uint8, device=self.device)
        labels, metas = [], []
        for s in range(0, n, self.CHUNK):
            part = first if s == 0 else source.gather(
                np.arange(s, min(s + self.CHUNK, n)))
            self.images[s:s + len(part["label"])].copy_(
                torch.from_numpy(np.ascontiguousarray(part["image"])))
            labels.append(np.asarray(part["label"], np.int32))
            metas.append(np.asarray(part["metadata"], np.float32))
        self.labels = np.concatenate(labels)
        self.metadata = np.concatenate(metas)
        self.labels_dev = torch.from_numpy(self.labels).to(self.device)
        self.meta_dev = torch.from_numpy(self.metadata).to(self.device)

    @staticmethod
    def nbytes_estimate(source) -> int:
        if hasattr(source, "images"):           # ArrayDataSource
            return source.images.nbytes
        ch = 4 if getattr(source, "mask_dir", None) is not None else 3
        canvas = getattr(source, "canvas", 0)
        return len(source) * canvas * canvas * ch

    def __len__(self):
        return len(self.labels)

    def _take(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("data.gather"):
            return {"image": self.images.index_select(0, idx),
                    "label": self.labels_dev.index_select(0, idx),
                    "metadata": self.meta_dev.index_select(0, idx)}

    def gather(self, indices: np.ndarray) -> Dict[str, torch.Tensor]:
        idx = torch.from_numpy(np.asarray(indices, np.int64).reshape(-1))
        return self._take(idx.to(self.device))

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      weighted: bool, drop_last: bool = True
                      ) -> Iterator[Dict[str, torch.Tensor]]:
        plan = epoch_indices(self.labels, batch_size, rng, weighted=weighted,
                             drop_last=drop_last)
        plan = torch.from_numpy(plan.astype(np.int64)).to(self.device)  # one copy
        for row in plan:
            yield self._take(row)

    def sequential_batches(self, batch_size: int
                           ) -> Iterator[Dict[str, torch.Tensor]]:
        order = torch.arange(len(self), device=self.device)
        for s in range(0, len(self), batch_size):
            yield self._take(order[s:s + batch_size])


def maybe_device_resident(source, cfg: Config, device):
    """``source`` as a DeviceDataSource on ``device`` when that is a CUDA
    device, ``data.device_resident_mb`` is positive and the canvases fit it,
    and training is not data-parallel; else ``source`` itself."""
    if source is None or isinstance(source, DeviceDataSource):
        return source
    budget = cfg.data.device_resident_mb
    if torch.device(device).type != "cuda" or budget <= 0 or \
            cfg.training.data_parallel:
        return source
    if DeviceDataSource.nbytes_estimate(source) > budget * 2 ** 20:
        return source
    return DeviceDataSource(source, device)


def make_device_augment(cfg: Config, train: bool) -> Callable:
    """Device-side augmentation: raw uint8 canvas batch → model-ready batch.

    Returns fn(batch, generator=None) → batch with "image" (B, S, S, C)
    normalized float32 on the batch's device, the mask as the 4th channel
    when configured: a packed 4th channel, else, under
    ``data.on_device_masks``, the segmentation of the canvas at its own size
    (``ops/cvseg.py``), else zeros. With ``train`` it is the train
    transform, whose draws come from ``generator``, a ``torch.Generator`` on
    the batch's device; else the deterministic eval transform, which draws
    nothing."""
    size = cfg.model.image_size
    use_mask = cfg.data.use_segmentation_mask
    on_device_masks = cfg.data.on_device_masks
    aug = cfg.augmentation.train
    cj = aug.color_jitter

    def fn(batch: Dict[str, torch.Tensor],
           generator: Optional[torch.Generator] = None
           ) -> Dict[str, torch.Tensor]:
        raw = batch["image"]
        img = I.to_float(raw[..., :3])
        mask = None
        if use_mask:
            if raw.shape[-1] == 4:
                mask = I.to_float(raw[..., 3:4])
            elif on_device_masks:
                mask = segment_lesion_batch(img, img.shape[1])
            else:
                mask = img.new_zeros(img.shape[:3] + (1,))
        if train:
            if generator is None:
                raise ValueError("the train augment draws from a "
                                 "torch.Generator: pass one")
            draws = I.draw_train(
                generator, img.shape[0], img.shape[1], img.shape[2],
                aug.random_resized_crop.scale, aug.random_resized_crop.ratio,
                aug.horizontal_flip, aug.vertical_flip, aug.rotation,
                (cj.brightness, cj.contrast, cj.saturation, cj.hue),
                aug.randaugment.n if aug.randaugment.enabled else 0)
            img, mask = I.train_transform(img, mask, draws, out_size=size,
                                          randaugment_m=aug.randaugment.m)
        else:
            img, mask = I.eval_transform(img, mask, out_size=size)
        if mask is not None:
            img = torch.cat([img, mask], dim=-1)
        return dict(batch, image=img)

    return fn
