"""Segmentation evaluator: dataset-level metrics, confusion matrix,
prediction analysis, failure-case mining (counterpart of the JAX package's
``evaluation/segmentation.py``).

Behavioral spec: train/evaluate.py — confusion-matrix metrics :88-137,
CM heatmap :139-168, 4-panel prediction analysis with confidence maps
:170-238, failure mining below an IoU threshold :240-295. One forward per
batch also returns *per-image* card IoU so failure mining needs no second
pass, and all metric math happens on exact global confusion counts (not
batch averages).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch import metrics as metrics_lib
from mtg_card_image_segmentation_tpu_torch.evaluation.worstk import (
    fresh_failures_dir,
    merge_worst_k,
)
from mtg_card_image_segmentation_tpu_torch.parallel.distributed import all_reduce_sum
from mtg_card_image_segmentation_tpu_torch.utils import plots as plots_lib


def make_analysis_step(model: torch.nn.Module, num_classes: int = 2):
    """``step(images, masks, weights)`` -> (per-image card IoU, confusion
    counts, pred masks, card-probability maps), all on the model's device.
    ``images`` are normalized NHWC floats, ``masks`` (B, H, W) ints.
    ``weights`` is a per-image 0/1 vector — padded rows of the last eval
    batch carry 0 and contribute no confusion counts. Under a process group
    the confusion counts are summed over the ranks; the per-image outputs
    stay the rank's own."""

    @torch.inference_mode()
    def step(images: torch.Tensor, masks: torch.Tensor, weights: torch.Tensor):
        logits = model.eval()(images)
        pred = torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float(), dim=-1)
        cm = all_reduce_sum(metrics_lib.confusion_matrix(pred, masks, num_classes, weights))
        card_pred = (pred == 1).float()
        card_tgt = (masks == 1).float()
        inter = torch.sum(card_pred * card_tgt, dim=(1, 2))
        union = torch.sum(card_pred, dim=(1, 2)) + torch.sum(card_tgt, dim=(1, 2)) - inter
        per_image_iou = torch.where(union > 0, inter / torch.clamp(union, min=1),
                                    torch.ones_like(union))
        return per_image_iou, cm, pred.to(torch.uint8), probs[..., 1]

    return step


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SegEvaluator:
    """``SegEvaluator(model)``: ``model`` maps normalized NHWC images to
    (B, H, W, num_classes) logits on its device; batches must live there."""

    def __init__(self, model: torch.nn.Module, num_classes: int = 2) -> None:
        self.model = model
        self.num_classes = num_classes
        self._step = make_analysis_step(model, num_classes)

    def evaluate(
        self,
        batches: Iterable[Tuple[torch.Tensor, ...]],
        output_dir: Optional[str] = None,
        failure_iou_threshold: float = 0.5,
        save_plots: bool = False,
        max_failures: int = 16,
        worst_k: int = 8,
    ) -> Dict:
        """Run the full evaluation. Returns the report dict (and writes
        evaluation_report.json + plots under ``output_dir`` when given).

        Failure mining is two-tier: images below ``failure_iou_threshold``
        are recorded as failures (train/evaluate.py:240-295 semantics), and
        independently the ``worst_k`` lowest-IoU images are kept as viewable
        panels even when nothing crosses the threshold — a model good enough
        to clear 0.5 everywhere still has a worst tail worth looking at."""
        cm_total = np.zeros((self.num_classes, self.num_classes), np.int64)
        ious: List[float] = []
        failures: List[Dict] = []
        failure_arrays: List[Tuple] = []
        # running worst-k buffer: list of (iou, global_index, arrays-tuple)
        worst: List[Tuple] = []
        sample_panels = None
        seen = 0

        for batch_idx, batch in enumerate(batches):
            # batches yield (images, masks) or (images, masks, valid) — the
            # file pipeline pads the last eval batch to a static shape and
            # reports the real sample count: padded rows must not enter the
            # confusion matrix, the per-image IoU or num_images
            images, masks = batch[0], batch[1]
            valid = int(batch[2]) if len(batch) > 2 else images.shape[0]
            weights = torch.from_numpy(
                (np.arange(images.shape[0]) < valid).astype(np.int64)).to(images.device)
            per_iou, cm, preds, conf = self._step(images, masks, weights)
            cm_total += _host(cm).astype(np.int64)
            per_iou = _host(per_iou)[:valid]
            ious.extend(per_iou.tolist())

            def arrays(i: int) -> Tuple[np.ndarray, ...]:
                return tuple(_host(t[i]) for t in (images, masks, preds, conf))

            bad = np.where(per_iou < failure_iou_threshold)[0]
            mined = set()
            for i in bad[: max(0, max_failures - len(failures))]:
                mined.add(int(i))
                failures.append(
                    {
                        "batch": batch_idx,
                        "index_in_batch": int(i),
                        "iou": float(per_iou[i]),
                    }
                )
                # keep the arrays so the mined failures are *viewable*
                # (train/evaluate.py:240-295 saves failure-case images; the
                # de-facto QA loop is looking at them)
                failure_arrays.append((*arrays(int(i)), float(per_iou[i])))
            if worst_k > 0:
                # merge this batch's iou-ascending candidates into the
                # running worst-k, skipping images already saved as failure
                # panels; arrays materialize only for admitted candidates
                def _entry(i, base=seen):
                    return lambda: (base + int(i), arrays(int(i)))

                merge_worst_k(
                    worst,
                    (
                        (float(per_iou[i]), _entry(i))
                        for i in np.argsort(per_iou)[: worst_k + len(mined)]
                        if int(i) not in mined
                    ),
                    worst_k,
                    reverse=False,
                )
            seen += valid
            if sample_panels is None:
                sample_panels = tuple(_host(t[:4]) for t in (images, masks, preds, conf))

        report = {
            "metrics": metrics_lib.metrics_from_confusion(cm_total),
            "confusion_matrix": cm_total.tolist(),
            "num_images": len(ious),
            "per_image_iou": {
                "mean": float(np.mean(ious)) if ious else 0.0,
                "median": float(np.median(ious)) if ious else 0.0,
                "min": float(np.min(ious)) if ious else 0.0,
                "below_threshold": len([x for x in ious if x < failure_iou_threshold]),
                "threshold": failure_iou_threshold,
            },
            "failures": failures,
            "worst_cases": [
                {"index": idx, "iou": iou} for iou, idx, _ in worst
            ],
        }
        # headline targets from the reference README (train/README.md:279-281)
        m = report["metrics"]
        report["targets"] = {
            "iou_card>0.85": m.get("iou_card", 0) > 0.85,
            "pixel_accuracy>0.95": m.get("pixel_accuracy", 0) > 0.95,
            "dice_card>0.90": m.get("dice_card", 0) > 0.90,
        }

        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            # wiped every run: stale panels from a previous decode must not
            # sit next to the regenerated ones
            fdir = fresh_failures_dir(output_dir)
            if failure_arrays or worst:
                # image/GT/pred/confidence panel per mined failure and per
                # worst-k case (train/evaluate.py:240-295)
                for rank, (img, msk, prd, cnf, iou) in enumerate(failure_arrays):
                    path = plots_lib.plot_predictions(
                        img[None], msk[None], prd[None],
                        os.path.join(fdir, f"failure_{rank:02d}_iou{iou:.3f}.png"),
                        confidences=cnf[None],
                    )
                    failures[rank]["panel"] = os.path.relpath(path, output_dir)
                for rank, (iou, idx, (img, msk, prd, cnf)) in enumerate(worst):
                    path = plots_lib.plot_predictions(
                        img[None], msk[None], prd[None],
                        os.path.join(fdir, f"worst_{rank:02d}_iou{iou:.3f}.png"),
                        confidences=cnf[None],
                    )
                    report["worst_cases"][rank]["panel"] = os.path.relpath(
                        path, output_dir
                    )
            with open(os.path.join(output_dir, "evaluation_report.json"), "w") as f:
                json.dump(report, f, indent=2)
            if save_plots:
                plots_lib.plot_confusion_matrix(
                    cm_total, os.path.join(output_dir, "confusion_matrix.png")
                )
                if sample_panels is not None:
                    imgs, msks, preds, conf = sample_panels
                    plots_lib.plot_predictions(
                        imgs, msks, preds,
                        os.path.join(output_dir, "prediction_analysis.png"),
                        confidences=conf,
                    )
        return report
