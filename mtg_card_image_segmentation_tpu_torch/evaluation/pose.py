"""Corner-keypoint evaluators: distance-threshold metrics + report generation
(counterpart of the JAX package's ``evaluation/pose.py``).

Behavioral spec: train-pose-estimation_yolo12n/evaluate_model.py — Euclidean
errors :135-158, accuracy@{5,10,20}px :160-185, per-corner accuracy
:187-217, detection rate / mean/median/std / inference-time tracking
:219-326, JSON + plots + text report :489-668 — plus the custom pipeline's
3px/6px metrics (train-pose-estimation_custom/metrics.py:89-102).

Whenever ``evaluate`` is given an output directory it draws its plots
(matplotlib, imported only then): call it with ``output_dir=None`` on a
host without matplotlib.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.evaluation.worstk import (
    fresh_failures_dir,
    merge_worst_k,
)
from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm_lib
from mtg_card_image_segmentation_tpu_torch.utils.plots import _plt

CORNER_NAMES = ("top_left", "top_right", "bottom_right", "bottom_left")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def heatmap_predict_step(model: torch.nn.Module, image_hw: tuple[int, int]):
    """``step(images) -> (corners_px (B,4,2), conf (B,4))`` of an HRNet
    heatmap model on its device: the independent sub-pixel decode with the
    per-image plausibility-gated fallback to the joint-NMS assignment."""

    @torch.inference_mode()
    def step(images):
        coords01, conf = hm_lib.decode_argmax_subpixel_gated(model.eval()(images))
        return hm_lib.coords01_to_pixels(coords01, image_hw), conf

    return step


def yolo_predict_step(model: torch.nn.Module):
    """The YOLO corner-prediction step for :class:`PoseEvaluator`: the
    decoded model (boxes/scores/kpts), the top-1 detection (max_det=1,
    *_yolo12n/model.py:215-264), its 4 keypoints as corner pixels with the
    detection confidence per corner (evaluate_model.py:74-133, batched)."""
    from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import top1_detection

    @torch.inference_mode()
    def step(images):
        boxes, scores, kpts = model.eval()(images)
        _, conf, kk = top1_detection(boxes, scores, kpts)
        px = kk[..., :2].float()  # (B, 4, 2) in input-pixel space
        return px, conf.float()[:, None].expand(px.shape[:2])

    return step


class PoseEvaluator:
    """``PoseEvaluator(model, image_hw)``: ``model`` maps (B, H, W, 3) images
    in [0, 1] to heatmaps on its device; batches must live there.
    ``predict_step(images) -> (corners_px (B,4,2), conf (B,4))`` replaces
    the heatmap decode (the YOLO evaluator plugs its detection decode in
    through it)."""

    def __init__(
        self,
        model: Optional[torch.nn.Module],
        image_hw: tuple[int, int],
        peak_threshold: float = 0.3,
        thresholds: Sequence[float] = (3.0, 5.0, 6.0, 10.0, 20.0),
        predict_step=None,
    ) -> None:
        self.image_hw = image_hw
        self.thresholds = tuple(thresholds)
        self.peak_threshold = peak_threshold
        self._step = predict_step or heatmap_predict_step(model, image_hw)

    def evaluate(
        self,
        batches: Iterable,  # (images, _, corners_px) or (images, corners_px)
        output_dir: Optional[str] = None,
        worst_k: int = 8,
    ) -> Dict:
        all_err: List[np.ndarray] = []
        all_conf: List[np.ndarray] = []
        times: List[float] = []
        # running worst-k by max corner error: (max_err, global_idx, img, gt, pred)
        worst: List[tuple] = []
        seen = 0
        warmed_up = False
        platform = None
        for batch in batches:
            images, corners = batch[0], batch[-1]
            platform = images.device.type
            if not warmed_up:
                # untimed warm-up: the first call pays cuDNN's algorithm
                # choice and must not enter the inference time
                _host(self._step(images)[0])
                warmed_up = True
            t0 = time.perf_counter()
            px, conf = self._step(images)
            px = _host(px)  # the copy to the host fences the timing
            times.append((time.perf_counter() - t0) / images.shape[0])
            conf = _host(conf)
            c = _host(corners)
            err = np.sqrt(((px - c) ** 2).sum(-1))
            all_err.append(err)
            all_conf.append(conf)
            if worst_k > 0:
                per_img = err.max(axis=1)

                # error-descending candidates; images are only copied to
                # the host for cases that enter the buffer
                def _entry(i, base=seen):
                    return lambda: (base + int(i), _host(images[int(i)]), c[int(i)],
                                    px[int(i)])

                merge_worst_k(
                    worst,
                    ((float(per_img[i]), _entry(i)) for i in np.argsort(-per_img)[:worst_k]),
                    worst_k,
                    reverse=True,
                )
            seen += int(err.shape[0])

        err = np.concatenate(all_err)  # (N, 4)
        conf = np.concatenate(all_conf)
        detected = conf >= self.peak_threshold

        report: Dict = {
            "platform": platform,  # where the timing was measured
            "num_images": int(err.shape[0]),
            "mean_error_px": float(err.mean()),
            "median_error_px": float(np.median(err)),
            "std_error_px": float(err.std()),
            "detection_rate": float(detected.all(axis=1).mean()),
            "mean_inference_time_ms_per_image": float(np.mean(times) * 1e3),
            "per_corner": {},
        }
        for t in self.thresholds:
            report[f"accuracy_{int(t)}px"] = float((err <= t).mean() * 100.0)
        for k, name in enumerate(CORNER_NAMES):
            report["per_corner"][name] = {
                "mean_error_px": float(err[:, k].mean()),
                **{
                    f"accuracy_{int(t)}px": float((err[:, k] <= t).mean() * 100.0)
                    for t in self.thresholds
                },
            }
        # reference quality tiers (*_yolo12n/README.md:163-171)
        report["tiers"] = {
            "acc5_target>80": report["accuracy_5px"] > 80,
            "acc10_target>90": report["accuracy_10px"] > 90,
            "acc20_target>95": report["accuracy_20px"] > 95,
            "mean_err_target<8px": report["mean_error_px"] < 8,
        }
        report["worst_cases"] = [{"index": idx, "max_error_px": e} for e, idx, *_ in worst]

        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            # wiped every run: stale worst-k panels from a previous decode
            # must not sit next to the regenerated ones
            fdir = fresh_failures_dir(output_dir)
            # GT-vs-pred corner panels of the worst cases (the pose analog
            # of the seg failure images, train/evaluate.py:240-295)
            for rank, (e, idx, img, gt, pred) in enumerate(worst):
                path = os.path.join(fdir, f"worst_{rank:02d}_err{e:.1f}px.png")
                self._plot_corner_panel(img, gt, pred, e, path)
                report["worst_cases"][rank]["panel"] = os.path.relpath(path, output_dir)
            with open(os.path.join(output_dir, "pose_evaluation.json"), "w") as f:
                json.dump(report, f, indent=2)
            self._write_text_report(report, os.path.join(output_dir, "report.txt"))
            self._plot_error_distribution(err, os.path.join(output_dir, "error_distribution.png"))
            self._plot_accuracy_curve(err, os.path.join(output_dir, "accuracy_curve.png"))
        return report

    @staticmethod
    def _plot_accuracy_curve(err: np.ndarray, path: str) -> None:
        """Accuracy-vs-threshold sweep, overall + per corner (the reference
        evaluator's accuracy/per-corner plots, evaluate_model.py:489-668)."""
        plt = _plt()
        ts = np.linspace(0.0, 20.0, 81)
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for k, name in enumerate(CORNER_NAMES):
            acc = [(err[:, k] <= t).mean() * 100.0 for t in ts]
            ax.plot(ts, acc, lw=1, alpha=0.7, label=name)
        overall = [(err <= t).mean() * 100.0 for t in ts]
        ax.plot(ts, overall, "k-", lw=2, label="overall")
        for t in (5.0, 10.0):
            ax.axvline(t, color="gray", ls=":", lw=0.8)
        ax.set_xlabel("error threshold (px)")
        ax.set_ylabel("accuracy (%)")
        ax.set_ylim(0, 102)
        ax.legend(fontsize=8)
        ax.set_title("corner accuracy vs threshold")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    @staticmethod
    def _plot_corner_panel(img: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                           max_err: float, path: str) -> None:
        plt = _plt()
        disp = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        fig, ax = plt.subplots(figsize=(5, 6))
        ax.imshow(disp)
        gt_closed = np.vstack([gt, gt[:1]])
        pr_closed = np.vstack([pred, pred[:1]])
        ax.plot(gt_closed[:, 0], gt_closed[:, 1], "g-o", ms=4, label="ground truth")
        ax.plot(pr_closed[:, 0], pr_closed[:, 1], "r--x", ms=6, label="prediction")
        for k, name in enumerate(CORNER_NAMES):
            d = float(np.sqrt(((pred[k] - gt[k]) ** 2).sum()))
            ax.annotate(f"{name}: {d:.1f}px", pred[k], color="r", fontsize=7,
                        xytext=(4, 4), textcoords="offset points")
        ax.set_title(f"max corner error {max_err:.1f}px")
        ax.legend(loc="lower right", fontsize=8)
        ax.set_axis_off()
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    @staticmethod
    def _write_text_report(report: Dict, path: str) -> None:
        lines = [
            "CORNER DETECTION EVALUATION",
            "=" * 40,
            f"images:          {report['num_images']}",
            f"mean error:      {report['mean_error_px']:.2f} px",
            f"median error:    {report['median_error_px']:.2f} px",
            f"detection rate:  {report['detection_rate'] * 100:.1f}%",
            f"inference time:  {report['mean_inference_time_ms_per_image']:.2f} ms/img",
            "",
        ]
        for key in sorted(k for k in report if k.startswith("accuracy_")):
            lines.append(f"{key}: {report[key]:.1f}%")
        lines.append("")
        for name, d in report["per_corner"].items():
            lines.append(f"{name}: mean {d['mean_error_px']:.2f}px")
        with open(path, "w") as f:
            f.write("\n".join(lines))

    @staticmethod
    def _plot_error_distribution(err: np.ndarray, path: str) -> None:
        plt = _plt()
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        axes[0].hist(err.ravel(), bins=40)
        axes[0].set_title("corner error (px)")
        axes[1].boxplot([err[:, k] for k in range(err.shape[1])],
                        tick_labels=list(CORNER_NAMES))
        axes[1].tick_params(axis="x", rotation=20)
        axes[1].set_title("per-corner error")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)


class CornerEvaluator(PoseEvaluator):
    """YOLO-family corner evaluator (reference CornerEvaluator,
    *_yolo12n/evaluate_model.py:42-326): the heatmap evaluator's report
    schema, fed by the YOLO detection decode of ``model`` (a
    ``YOLO12Pose`` whose forward returns boxes, scores and keypoints)."""

    def __init__(
        self,
        model: torch.nn.Module,
        image_hw: tuple[int, int],
        conf_threshold: float = 0.25,
        thresholds: Sequence[float] = (3.0, 5.0, 6.0, 10.0, 20.0),
    ) -> None:
        super().__init__(
            model=None,
            image_hw=image_hw,
            peak_threshold=conf_threshold,
            thresholds=thresholds,
            predict_step=yolo_predict_step(model),
        )
