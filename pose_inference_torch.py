#!/usr/bin/env python
"""Corner-detection inference CLI of the PyTorch port (counterpart of
``pose_inference.py``; reference: train-pose-estimation_custom/
inference_test.py — dual backend .pth/.onnx with a session fallback ladder
:64-139, preprocess, peak extraction with a threshold, scale to the
original frame, visualization, timing). Runs on the CUDA card;
``--device cpu`` runs on the host.

  python pose_inference_torch.py --checkpoint ckpts/best_model --image card.jpg
  python pose_inference_torch.py --checkpoint ckpts/best_model --synthetic 4
  python pose_inference_torch.py --onnx runs/pose/exported --synthetic 2
  python pose_inference_torch.py --checkpoint runs/yolo/checkpoints/best_model \\
      --family yolo --synthetic 4
  python pose_inference_torch.py --onnx exported_models_yolo --family yolo --synthetic 2
  python pose_inference_torch.py --pt2 exported_models_yolo --family yolo --synthetic 2

--family hrnet (the default) runs an HRNet checkpoint or, with --onnx, a
shipped HRNet artifact through the port's torch ONNX executor; a package
DIRECTORY walks the int8 -> fp16 -> fp32 -> dynamic ladder, and every rung
that falls is printed with its reason. --family yolo runs a YOLO12n-pose
checkpoint through ``YoloCornerPredictor`` or, with --onnx, a shipped YOLO
artifact (the ``yolo`` ladder) whose output0 goes through the numpy client
decode (export/yolo_client_decode.py), as the JAX CLI does. --pt2 PATH
runs the family's torch.export artifact (a .pt2 file, or pose.pt2 /
yolo.pt2 in a package directory), the counterpart of the JAX CLI's
--stablehlo, with no ladder; the YOLO one's output0 goes through the same
client decode.

--synthetic N renders N scenes from seeds 123 + i with the port's renderer
on the host (a torch.Generator): the same images on every device, but not
the JAX CLI's images, which come from JAX keys.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

SYNTHETIC_SEED = 123


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--onnx", default=None, metavar="PATH",
                        help="run a shipped .onnx artifact (or walk a package "
                             "directory's int8->fp16->fp32->dynamic ladder) instead of "
                             "a checkpoint")
    parser.add_argument("--pt2", default=None, metavar="PATH",
                        help="run a torch.export artifact (.pt2 file or package directory)")
    parser.add_argument("--image", type=str, default=None, help="image file to run on")
    parser.add_argument("--synthetic", type=int, default=0, help="run on N synthetic samples")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--threshold", type=float, default=0.3)
    parser.add_argument("--family", choices=["hrnet", "yolo"], default="hrnet",
                        help="corner model family the checkpoint holds")
    parser.add_argument("--imgsz", type=int, default=640,
                        help="square YOLO input size (--family yolo)")
    parser.add_argument("--output-dir", default="pose_inference_out")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if sum(a is not None for a in (args.checkpoint, args.onnx, args.pt2)) != 1:
        parser.error("give exactly one of --checkpoint / --onnx / --pt2")
    if args.family == "yolo" and (args.config or args.set):
        parser.error("--family yolo is configured by --imgsz/--threshold only; "
                     "--config/--set apply to the hrnet family")
    if not args.image and args.synthetic <= 0:
        parser.error("give --image or --synthetic N")

    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import Config, pose_default_config
    from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm_lib
    from mtg_card_image_segmentation_tpu_torch.ops.resize import bilinear_resize
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = Config.from_json(args.config) if args.config else pose_default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)

    def resized(images01: np.ndarray, h: int, w: int) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images01, np.float32)).to(device)
        return bilinear_resize(x, h, w)

    reasons: List[str] = []

    def load_artifact(family):
        from mtg_card_image_segmentation_tpu_torch.serving import artifact_backend

        if args.pt2:
            runner, source = artifact_backend.load_program(args.pt2, family, device)
            print(f"loaded artifact {source} ({family})")
            return runner, source
        runner, source, fell = artifact_backend.load_onnx(args.onnx, family, device)
        reasons.extend(fell)
        print(f"loaded artifact {source} ({family})")
        print(f"ladder fell past: {json.dumps(fell)}")
        return runner, source

    if args.family == "yolo" and args.checkpoint is None:
        from mtg_card_image_segmentation_tpu_torch.export.yolo_client_decode import (
            decode as client_decode,
        )

        h = w = args.imgsz
        runner, source = load_artifact("yolo")

        def infer(images01):
            # stretch-resize to the square input, the joint client decode of
            # the graph's output0 (one image), mapped back to the original
            # frame with the (size-1) convention, then to coords01
            h0, w0 = images01.shape[1:3]
            x = resized(images01, h, w).permute(0, 3, 1, 2).cpu().numpy()
            _, _, kp = client_decode(runner(x), num_keypoints=4)
            px0 = kp[:, :2] * np.asarray([(w0 - 1) / (w - 1), (h0 - 1) / (h - 1)])
            coords01 = px0 / np.asarray([w0 - 1.0, h0 - 1.0])
            return torch.from_numpy(coords01[None]), torch.from_numpy(kp[None, :, 2])

    elif args.family == "yolo":
        from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import (
            YoloCornerPredictor,
        )

        h = w = args.imgsz
        ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
        predictor = YoloCornerPredictor.from_checkpoint(
            ckpt_dir or ".", name, imgsz=args.imgsz, threshold=args.threshold, device=device)
        source = args.checkpoint
        print(f"loaded {args.checkpoint} (yolo12n_pose, imgsz={args.imgsz})")

        def infer(images01):
            # stretch-resize to the square YOLO input (ultralytics imgsz
            # semantics), requantize for the predictor's uint8 contract, map
            # back to the original frame with the YOLO half-pixel
            # convention, then to coords01 by (size-1)
            h0, w0 = images01.shape[1:3]
            u8 = (resized(images01, h, w) * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
            px, conf = predictor.predict(u8)
            px0 = predictor.scale_to_original(px, (h0, w0))
            return px0 / torch.tensor([w0 - 1.0, h0 - 1.0], device=px0.device), conf

    else:
        h, w = cfg.pose.input_height, cfg.pose.input_width
        if args.checkpoint is None:
            runner, source = load_artifact("hrnet")

            def heatmaps_of(x):
                out = runner(x.permute(0, 3, 1, 2).cpu().numpy())  # (B, K, hm_h, hm_w)
                return torch.from_numpy(np.ascontiguousarray(out.transpose(0, 2, 3, 1)))

        else:
            from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
            from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax

            ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
            params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
            model = hrnet_from_flax(params, batch_stats,
                                    (cfg.pose.heatmap_height, cfg.pose.heatmap_width),
                                    dtype=getattr(torch, cfg.pose.compute_dtype)).to(device)
            source = args.checkpoint
            print(f"loaded {args.checkpoint} (epoch {meta.get('epoch')})")

            def heatmaps_of(x):
                return model(x)

        @torch.inference_mode()
        def infer(images01):
            """Resize to the model input, [0,1] as it is (no ImageNet
            normalization, inference_test.py:167-169), heatmaps, the gated
            sub-pixel decode the evaluator and the server use."""
            return hm_lib.decode_argmax_subpixel_gated(heatmaps_of(resized(images01, h, w)))

    samples = []  # (name, (H0, W0, 3) float32 [0,1] numpy)
    if args.image:
        import cv2

        raw = cv2.cvtColor(cv2.imread(args.image), cv2.COLOR_BGR2RGB)
        samples.append((os.path.basename(args.image), raw.astype(np.float32) / 255.0))
    for i in range(args.synthetic):
        from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_sample

        s = synthetic_sample(torch.Generator().manual_seed(SYNTHETIC_SEED + i), h, w, 0.0)
        samples.append((f"synthetic_{i}", s.image.numpy()))

    os.makedirs(args.output_dir, exist_ok=True)
    results = []
    for sample_name, img in samples:
        t0 = time.perf_counter()
        coords01, conf = infer(img[None])
        # the copy fences the computation; float64 stays float64 (the client
        # decode's), float32 widens exactly
        coords01 = coords01[0].double().cpu().numpy()
        conf = conf[0].double().cpu().numpy()
        dt_ms = (time.perf_counter() - t0) * 1e3
        h0, w0 = img.shape[:2]
        px = coords01 * np.array([w0 - 1, h0 - 1])  # scale to the original size
        valid = conf >= args.threshold
        res = {
            "sample": sample_name,
            "corners_xy": px.round(2).tolist(),
            "confidences": conf.round(3).tolist(),
            "valid": valid.tolist(),
            "inference_ms": round(dt_ms, 2),
        }
        results.append(res)
        print(json.dumps(res))

        if args.visualize:
            from mtg_card_image_segmentation_tpu_torch.utils.plots import _plt

            plt = _plt()
            fig, ax = plt.subplots(figsize=(6, 5))
            ax.imshow(img)
            colors = ["red", "lime", "blue", "yellow"]
            for k in range(4):
                ax.scatter(*px[k], c=colors[k], s=80, marker="o" if valid[k] else "x")
                ax.annotate(f"{conf[k]:.2f}", px[k], color=colors[k], fontsize=8)
            if valid.sum() >= 3:
                poly = np.vstack([px[valid], px[valid][:1]])
                ax.plot(poly[:, 0], poly[:, 1], "c--", alpha=0.7)
            ax.axis("off")
            out = os.path.join(args.output_dir, f"{sample_name}_corners.png")
            fig.savefig(out, dpi=120, bbox_inches="tight")
            plt.close(fig)
            print(f"  visualization -> {out}")

    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return {"source": source, "ladder_fell_past": reasons, "results": results}


if __name__ == "__main__":
    main()
