"""The system under test for a ``seg`` configuration: the port's
``SegPredictor`` at its defaults (bf16, blocks 12-14 as the tail chain, the
mask decode kernel), built from the seeded Flax-layout trees; or, as the
control, the plain reference in fp8 put in its place."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class Program:
    def __init__(self, cfg: Dict, params: Dict, stats: Dict, cell: Dict, device,
                 reference=None):
        h, w = cell["traffic_params"]["height"], cell["traffic_params"]["width"]
        self.control = reference is not None
        if self.control:
            self.ref, self.cfg = reference, cfg
            self.p = reference.tensors(params, device)
            self.s = reference.tensors(stats, device)
            self.device = device
        else:
            from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

            self.pred = SegPredictor(params, stats, h, w, device=device)

    def step(self, images_u8):
        """One served batch: (B, H, W, 3) uint8 host tensor -> device masks."""
        if self.control:
            with torch.no_grad(), self.ref.ieee_fp32():
                x = images_u8.to(self.device, non_blocking=True)
                return self.ref.masks(self.cfg, self.p, self.s, x, precision="fp8")
        return self.pred.predict(images_u8)

    @staticmethod
    def to_host(out) -> Dict[str, np.ndarray]:
        return {"masks": out.cpu().numpy()}

    def close(self) -> None:
        self.__dict__.clear()
