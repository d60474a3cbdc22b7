"""Input pipelines (counterpart of the JAX package's ``data/pipeline.py``):
a synthetic stream rendered and augmented on the device, its
corner-keypoint variant with Gaussian heatmap targets, and a file stream
decoded on the host and resized, augmented and normalized on the device.

Under a ``torch.distributed`` process group of more than one rank
``batch_size`` is the global batch, and each rank makes its
``local_batch_size`` share (``parallel/distributed.py``): the synthetic
streams draw from a generator seeded from (seed, rank), and the file
stream decodes the rank's ``process_shard`` of the file order, as the JAX
pipelines do per process.

Both replace the reference's torch DataLoader (train/dataset.py:208-260,
4 CPU workers doing decode + augment per sample).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
from mtg_card_image_segmentation_tpu_torch.data.augment import augment_batch, draw_augment
from mtg_card_image_segmentation_tpu_torch.data.dataset import CardSegmentationDataset
from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only, preprocess_batch
from mtg_card_image_segmentation_tpu_torch.data.synthetic import (
    NEGATIVE_PROB,
    synthetic_augmented_batch,
    synthetic_batch,
)
from mtg_card_image_segmentation_tpu_torch.parallel import distributed
from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device


def rank_seed(seed: int) -> int:
    """``seed`` on one process; under more than one rank a seed drawn from
    (seed, rank), so that every rank draws its own stream."""
    if distributed.process_count() == 1:
        return seed
    return int(np.random.SeedSequence([seed, distributed.process_index()])
               .generate_state(1)[0])


class SyntheticPipeline:
    """Infinite stream of rendered (+ augmented) normalized batches on the
    device: (B,H,W,3) float32 images and (B,H,W) int32 masks, B the
    rank's share of ``batch_size``. One ``torch.Generator`` on the device,
    seeded from ``seed`` (and the rank: :func:`rank_seed`), draws them
    all."""

    def __init__(self, batch_size: int, height: int, width: int,
                 augment: Optional[AugmentConfig] = AugmentConfig(), seed: int = 0,
                 assets=None, real_prob: float = 0.7, device=None) -> None:
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.augment = augment
        self.assets = assets
        self.real_prob = real_prob
        self.device = resolve_device(device)
        self._local_bs = distributed.local_batch_size(batch_size)
        self._gen = torch.Generator(device=self.device).manual_seed(rank_seed(seed))

    def next_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        aug = self.augment
        if aug is not None and aug.enabled:
            # fused render + augment: the geometry composes into the render
            # coordinates (see synthetic.render_augmented_scene)
            sample = synthetic_augmented_batch(
                self._gen, self._local_bs, self.height, self.width, NEGATIVE_PROB, aug,
                assets=self.assets, real_prob=self.real_prob)
        else:
            sample = synthetic_batch(self._gen, self._local_bs, self.height, self.width,
                                     NEGATIVE_PROB, self.assets, self.real_prob)
        return normalize_only(sample.image), sample.mask

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        while True:
            yield self.next_batch()


class PoseSyntheticPipeline:
    """Infinite stream of (images01, target_heatmaps, corners_px) on the
    device for the corner-keypoint pipelines: (B,H,W,3) float32 images
    /255 only (no ImageNet normalization, inference_test.py:167-169),
    (B,hm_h,hm_w,K) Gaussian targets with ``sigma`` 2
    (train-pose-estimation_custom/dataset.py:317-331), (B,4,2) corners in
    canonical image-space TL,TR,BR,BL order. Negatives are off (corner
    annotations exist only for card images) and the base scene keeps its
    corners in view. One ``torch.Generator`` on the device, seeded from
    ``seed``, draws them all. (A flip's corner reordering, the JAX
    pipeline's ``FLIP_IDX``, is the re-canonicalisation in
    ``synthetic.render_augmented_scene``.)"""

    def __init__(self, batch_size: int, height: int, width: int, heatmap_height: int,
                 heatmap_width: int, sigma: float = 2.0,
                 augment: Optional[AugmentConfig] = None, seed: int = 0,
                 device=None) -> None:
        self.batch_size = batch_size
        self.height, self.width = height, width
        self.heatmap_hw = (heatmap_height, heatmap_width)
        self.sigma = sigma
        self.augment = augment
        self.device = resolve_device(device)
        self._local_bs = distributed.local_batch_size(batch_size)
        self._gen = torch.Generator(device=self.device).manual_seed(rank_seed(seed))

    def next_batch(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        from mtg_card_image_segmentation_tpu_torch.ops.heatmap import (
            gaussian_heatmaps_batch,
            pixels_to_heatmap_coords,
        )

        aug, h, w = self.augment, self.height, self.width
        if aug is not None and aug.enabled:
            # fused render + augment, keypoint path: no elastic/grid, so the
            # corners stay exact; the affine may still push some out of view
            sample = synthetic_augmented_batch(
                self._gen, self._local_bs, h, w, 0.0, aug, with_displacement=False,
                keep_in_frame=True)
        else:
            sample = synthetic_batch(self._gen, self._local_bs, h, w, 0.0,
                                     keep_in_frame=True)
        hm_coords = pixels_to_heatmap_coords(sample.corners, (h, w), self.heatmap_hw)
        targets = gaussian_heatmaps_batch(hm_coords, *self.heatmap_hw, self.sigma)
        return sample.image, targets, sample.corners

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        while True:
            yield self.next_batch()


class FilePipeline:
    """Host decode (cv2, one prefetch thread) -> device resize / normalize /
    augment.

    Yields ``steps_per_epoch`` ``(images, masks, valid)`` triples per epoch,
    ``valid`` being the number of real (non-padded) leading samples; pass
    ``shuffle=False`` for evaluation. The last incomplete batch is dropped in
    training (the reference's drop_last=True) and padded to the static batch
    shape otherwise: consumers weight by ``valid``. The shuffle order is
    ``np.random.default_rng(seed)``'s, the JAX pipeline's own.

    The prefetch thread only decodes. The copy to the device and all device
    work stay on the consuming thread: a fresh thread that touches the card
    pays for its own cuDNN/cuBLAS handles (45-250 ms on an H100 host).

    Under more than one rank each rank decodes its ``process_shard`` of the
    file order (shuffled by the same seed on every rank) in batches of its
    share of ``batch_size``, and ``steps_per_epoch`` comes from the global
    count, so that every rank joins the same collectives; this is a
    training path and needs ``drop_last`` (the JAX pipeline's rule).
    """

    def __init__(self, dataset: CardSegmentationDataset, batch_size: int, height: int,
                 width: int, augment: Optional[AugmentConfig] = None, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2, device=None) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.augment = augment
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._local_bs = distributed.local_batch_size(batch_size)
        if distributed.process_count() > 1 and not drop_last:
            raise ValueError("a FilePipeline over several ranks needs drop_last")
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(rank_seed(seed))

    @property
    def steps_per_epoch(self) -> int:
        # from the global count, so that every rank agrees: each strided
        # shard holds at least n // ranks >= steps * local batch items
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _host_batches(self):
        """One epoch of host batches: (B,H,W,3) uint8, (B,H,W) uint8, valid."""
        order = np.arange(len(self.dataset))
        if distributed.process_count() > 1:
            order = np.asarray(distributed.process_shard(list(order)))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self._local_bs
        for b in range(self.steps_per_epoch):
            idxs = order[b * bs:(b + 1) * bs]
            imgs, masks = [], []
            for i in idxs:
                img, m = self.dataset.load_raw(int(i))
                imgs.append(img)
                masks.append(m)
            while len(imgs) < bs:  # eval padding
                imgs.append(np.zeros_like(imgs[0]))
                masks.append(np.zeros_like(masks[0]))
            # host-side resize to a common shape only if sizes differ
            if len({im.shape for im in imgs}) > 1:
                import cv2

                h0, w0 = imgs[0].shape[:2]
                imgs = [cv2.resize(im, (w0, h0), interpolation=cv2.INTER_LINEAR) for im in imgs]
                masks = [cv2.resize(m, (w0, h0), interpolation=cv2.INTER_NEAREST)
                         for m in masks]
            yield np.stack(imgs), np.stack(masks), len(idxs)

    def _device_batch(self, imgs_u8: np.ndarray, masks_u8: np.ndarray):
        """A host batch -> device (images, masks). As in the JAX pipeline,
        normalization happens in ``preprocess_batch`` only without an
        ``augment`` config, and after the augmentation only with an enabled
        one: an ``augment`` whose ``enabled`` is False yields [0, 1] images
        (the reference pipeline's behaviour, kept)."""
        images, masks = preprocess_batch(
            torch.from_numpy(imgs_u8).to(self.device), torch.from_numpy(masks_u8).to(self.device),
            self.height, self.width, self.augment is None)
        if self.augment is not None and self.augment.enabled:
            draws = draw_augment(self._gen, images.shape[0], self.height, self.width,
                                 self.augment)
            out = augment_batch(draws, images, masks, self.augment)
            images, masks = normalize_only(out.image), out.mask
        return images, masks

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
        """One epoch of device batches, decoded ahead by a host thread. The
        thread stops when the epoch ends or the iterator is closed; a decode
        error is raised here."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._host_batches():
                    if not put(item):
                        return
                put(done)
            except Exception as e:  # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                imgs_u8, masks_u8, valid = item
                images, masks = self._device_batch(imgs_u8, masks_u8)
                yield images, masks, valid
        finally:
            stop.set()
            t.join(timeout=10)
