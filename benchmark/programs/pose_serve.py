"""The system under test for a ``pose`` configuration: the port's
``PosePredictor`` at its defaults (bf16, the normalize kernel, the gated
sub-pixel decode). A served batch is ``predict``'s two stages as
``predict`` runs them, ``decode(heatmaps(x))``, so that the heatmaps the
corners were decoded from can be judged too. The control is the plain
reference in fp8 with its own decode, put in its place."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class Program:
    def __init__(self, cfg: Dict, params: Dict, stats: Dict, cell: Dict, device,
                 reference=None):
        self.hw = (cell["traffic_params"]["height"], cell["traffic_params"]["width"])
        self.control = reference is not None
        if self.control:
            self.ref, self.cfg, self.device = reference, cfg, device
            self.net = reference.Net(cfg, params, stats, device, precision="fp8")
        else:
            from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor

            self.pred = PosePredictor(params, stats, *self.hw,
                                      heatmap_hw=tuple(cfg["heatmap_hw"]), device=device)

    def step(self, images_u8):
        """One served batch: (B, H, W, 3) uint8 host tensor -> (heatmaps,
        corners, confidences) on the device."""
        if self.control:
            with torch.no_grad(), self.ref.ieee_fp32():
                hm = self.net.heatmaps(images_u8.to(self.device, non_blocking=True))
            px, conf = self.ref.decode(self.cfg, hm.cpu().numpy(), self.hw)
            return hm, torch.from_numpy(px), torch.from_numpy(conf)
        hm = self.pred.heatmaps(images_u8)
        px, conf = self.pred.decode(hm)
        return hm, px, conf

    @staticmethod
    def to_host(out) -> Dict[str, np.ndarray]:
        hm, px, conf = out
        return {"heatmaps": hm.float().cpu().numpy(), "corners": px.cpu().numpy(),
                "conf": conf.cpu().numpy()}

    def close(self) -> None:
        self.__dict__.clear()
