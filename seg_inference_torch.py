#!/usr/bin/env python
"""Segmentation inference CLI of the PyTorch port (counterpart of
``seg_inference.py``): run a trained checkpoint OR a shipped deployment
artifact on images and report mask stats (reference: the generated
deployment package's inference_example.py, train/export.py:282-476, and
the dual-backend pattern of train-pose-estimation_custom/
inference_test.py:64-139). Runs on the CUDA card; ``--device cpu`` runs on
the host.

  python seg_inference_torch.py --checkpoint runs/seg/checkpoints/best_model --synthetic 2
  python seg_inference_torch.py --onnx runs/seg/exported --synthetic 2
  python seg_inference_torch.py --onnx runs/seg/exported/model_fp16.onnx --image card.jpg
  python seg_inference_torch.py --pt2 runs/seg/exported --synthetic 2

--onnx PATH runs through the port's torch ONNX executor; a package
DIRECTORY walks the int8 -> fp16 -> fp32 -> dynamic ladder, and every rung
that falls is printed with its reason. --pt2 PATH runs the torch.export
artifact (a .pt2 file, or model.pt2 in a package directory), the
counterpart of the JAX CLI's --stablehlo; it has no ladder. Output per
sample (one JSON line): card pixel fraction, mean card confidence,
inference time; --visualize writes the reference demo's cyan-overlay
rendering (demo/src/image-utils.js:190-227 behavior) as PNG (matplotlib).

--synthetic N renders N scenes from seeds 321 + i with the port's renderer
on the host (a torch.Generator): the same images on every device, but not
the JAX CLI's images, which come from JAX keys.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

SYNTHETIC_SEED = 321


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--onnx", default=None, metavar="PATH")
    parser.add_argument("--pt2", default=None, metavar="PATH",
                        help="run a torch.export artifact (.pt2 file or package directory)")
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--output-dir", default="seg_inference_out")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if sum(a is not None for a in (args.checkpoint, args.onnx, args.pt2)) != 1:
        parser.error("give exactly one of --checkpoint / --onnx / --pt2")
    if not args.image and args.synthetic <= 0:
        parser.error("give --image or --synthetic N")

    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import default_config
    from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
    from mtg_card_image_segmentation_tpu_torch.ops.resize import bilinear_resize
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)
    h, w = cfg.model.input_height, cfg.model.input_width

    def prep(images01: np.ndarray) -> torch.Tensor:
        """(B, H0, W0, 3) [0,1] -> ImageNet-normalized NHWC at (h, w)."""
        x = torch.from_numpy(np.ascontiguousarray(images01, np.float32)).to(device)
        return normalize_only(bilinear_resize(x, h, w))

    reasons: List[str] = []
    if args.onnx or args.pt2:
        from mtg_card_image_segmentation_tpu_torch.serving import artifact_backend

        if args.onnx:
            runner, source, reasons = artifact_backend.load_onnx(args.onnx, "seg", device)
        else:
            runner, source = artifact_backend.load_program(args.pt2, "seg", device)
        print(f"loaded artifact {source}")
        if args.onnx:
            print(f"ladder fell past: {json.dumps(reasons)}")

        def infer(images01):
            # exported IO contract: (B, 3, H, W) fp32 ImageNet-normalized
            # NCHW in, NCHW logits out
            x = prep(images01).permute(0, 3, 1, 2).cpu().numpy()
            return np.transpose(runner(x), (0, 2, 3, 1))

    else:
        from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
        from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax

        ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
        params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
        model = from_flax(params, batch_stats,
                          dtype=getattr(torch, cfg.model.compute_dtype)).to(device)
        source = args.checkpoint
        print(f"loaded {args.checkpoint} (epoch {meta.get('epoch')})")

        def infer(images01):
            with torch.inference_mode():
                return model(prep(images01)).float().cpu().numpy()

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
        logits = infer(img[None])  # (1, H, W, C); the copy to the host fences it
        dt_ms = (time.perf_counter() - t0) * 1e3
        prob = np.exp(logits - logits.max(-1, keepdims=True))
        prob /= prob.sum(-1, keepdims=True)
        mask = logits.argmax(-1)[0]  # (H, W), 1 = card
        res = {
            "sample": sample_name,
            "card_pixel_fraction": float((mask == 1).mean()),
            "mean_card_confidence": float(prob[0, ..., 1][mask == 1].mean())
            if (mask == 1).any() else 0.0,
            "inference_ms": round(dt_ms, 2),
        }
        results.append(res)
        print(json.dumps(res))

        if args.visualize:
            from mtg_card_image_segmentation_tpu_torch.utils.plots import _plt

            plt = _plt()
            disp = bilinear_resize(torch.from_numpy(img)[None], h, w)[0].numpy()
            # cyan overlay, alpha 128 — the demo's rendering
            overlay = disp.copy()
            overlay[mask == 1] = 0.5 * overlay[mask == 1] + 0.5 * np.array([0.0, 1.0, 1.0])
            fig, axes = plt.subplots(1, 2, figsize=(8, 5))
            axes[0].imshow(disp)
            axes[0].set_title(sample_name)
            axes[1].imshow(overlay)
            axes[1].set_title(f"card {res['card_pixel_fraction'] * 100:.1f}%")
            for ax in axes:
                ax.axis("off")
            out = os.path.join(args.output_dir, f"{sample_name}_mask.png")
            fig.savefig(out, dpi=120, bbox_inches="tight")
            plt.close(fig)
            print(f"  visualization -> {out}")

    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return {"source": source, "ladder_fell_past": reasons, "results": results}


if __name__ == "__main__":
    main()
