#!/usr/bin/env python
"""Dataset generation CLI of the PyTorch port (counterpart of
``generate_dataset.py``). Runs on the CUDA card; ``--device cpu`` runs on
the host.

Renders the synthetic scenes (``data/synthetic.py``) on the device and
writes them to disk in the reference's layout:

    dataset/{train,test}/{images/*.jpg, masks/*.png}
    dataset/corner_annotations.json

Each batch is drawn from its own ``torch.Generator`` seeded with
``seed_base + start`` (``seed_base`` 0 for train, 1,000,000,007 for test),
so a resumed run renders the same batches and skips the files that exist.

  python generate_dataset_torch.py --train 8800 --test 2180 --height 320 --width 240
  python generate_dataset_torch.py --watchdog --timeout-minutes 30 ...   # leak-tolerant wrapper
  python generate_dataset_torch.py --download-references                  # Scryfall (network)
  python generate_dataset_torch.py --download-backgrounds                 # Lorem Picsum (network)
  python generate_dataset_torch.py --derive-corners --yolo-output yolo_dataset

The last line of its output is one JSON object: images written and
skipped, seconds spent rendering and writing, images per second.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterator, List, Optional, Tuple

SPLIT_SEED = {"train": 0, "test": 1_000_000_007}


def render_batches(total: int, batch: int, height: int, width: int, seed_base: int,
                   device, assets=None, real_prob: float = 0.7
                   ) -> Iterator[Tuple[int, "object", "object", "object", "object"]]:
    """(start, images uint8 (n,H,W,3), masks uint8 0/255 (n,H,W), corners
    (n,4,2), has_card (n,)) as host numpy arrays, batch by batch: each batch
    rendered on ``device`` from a generator seeded with ``seed_base +
    start``, negatives at 9 %, corners kept in frame (the written
    annotations obey the mask-derived contract)."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch

    for start in range(0, total, batch):
        n = min(batch, total - start)
        gen = torch.Generator(device=device).manual_seed(seed_base + start)
        s = synthetic_batch(gen, batch, height, width, 0.09, assets, real_prob, True)
        imgs = (s.image * 255.0 + 0.5).to(torch.uint8)
        masks = s.mask.to(torch.uint8) * 255
        yield (start, imgs[:n].cpu().numpy(), masks[:n].cpu().numpy(),
               s.corners[:n].cpu().numpy(), s.has_card[:n].cpu().numpy())


def generate(output: str, counts: dict, height: int, width: int, batch: int, device,
             assets=None, real_prob: float = 0.7, log=print) -> dict:
    """Render and write every split; returns the counts, the annotations
    and the time spent."""
    import cv2

    annotations: dict = {}
    written = skipped = 0
    t0 = time.perf_counter()
    for split, total in counts.items():
        img_dir = os.path.join(output, split, "images")
        mask_dir = os.path.join(output, split, "masks")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)
        annotations[split] = {}
        done = 0
        for start, imgs, masks, corners, has in render_batches(
                total, batch, height, width, SPLIT_SEED[split], device, assets, real_prob):
            for i in range(imgs.shape[0]):
                name = f"synthetic_{start + i:06d}"
                img_path = os.path.join(img_dir, name + ".jpg")
                if os.path.exists(img_path):  # resume-skip
                    skipped += 1
                else:
                    cv2.imwrite(img_path, cv2.cvtColor(imgs[i], cv2.COLOR_RGB2BGR))
                    cv2.imwrite(os.path.join(mask_dir, name + ".png"), masks[i])
                    written += 1
                if has[i]:
                    annotations[split][name + ".jpg"] = corners[i].tolist()
                done += 1
            if (start // batch) % 10 == 0:
                log(f"[{split}] {done}/{total}")
        log(f"[{split}] done: {done} images")
    with open(os.path.join(output, "corner_annotations.json"), "w") as f:
        json.dump(annotations, f)
    seconds = time.perf_counter() - t0
    images = sum(counts.values())
    return {"written": written, "skipped": skipped, "images": images, "seconds": seconds,
            "img_per_s": images / seconds if seconds > 0 else None,
            "annotations": annotations}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--output", default="dataset")
    parser.add_argument("--train", type=int, default=8800)
    parser.add_argument("--test", type=int, default=2180)
    parser.add_argument("--height", type=int, default=320)
    parser.add_argument("--width", type=int, default=240)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--derive-corners", action="store_true",
                        help="re-derive corners from masks (preprocess_masks parity) "
                             "instead of using the renderer's exact corners")
    parser.add_argument("--yolo-output", default=None,
                        help="also materialize the YOLO-pose layout here")
    parser.add_argument("--real-assets", action="store_true",
                        help="composite downloaded card scans / background "
                             "photos into the renders (realism parity with "
                             "the reference's Blender pipeline)")
    parser.add_argument("--texture-dir", default=None)
    parser.add_argument("--background-dir", default=None)
    parser.add_argument("--hdri-dir", default=None)
    parser.add_argument("--real-prob", type=float, default=0.7)
    parser.add_argument("--download-references", action="store_true")
    parser.add_argument("--download-backgrounds", action="store_true")
    parser.add_argument("--watchdog", action="store_true",
                        help="wrap generation in the anti-leak watchdog")
    parser.add_argument("--timeout-minutes", type=float, default=30.0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    argv = sys.argv[1:] if argv is None else list(argv)

    if args.watchdog:
        from mtg_card_image_segmentation_tpu_torch.datagen.watchdog import run_with_watchdog

        cmd = [sys.executable, os.path.abspath(__file__)] + [
            a for a in argv if a != "--watchdog"]
        raise SystemExit(run_with_watchdog(cmd, args.timeout_minutes))

    if args.download_references or args.download_backgrounds:
        import requests  # the one network session, injected into the downloaders

        from mtg_card_image_segmentation_tpu_torch.datagen import downloaders

        session = requests.Session()
        if args.download_references:
            out = downloaders.ScryfallDownloader(os.path.join(args.output, "references"),
                                                 session=session).download()
        else:
            out = downloaders.BackgroundDownloader(args.output, session=session).download()
        print(out)
        return out

    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    assets = None
    if args.real_assets:
        from mtg_card_image_segmentation_tpu_torch.data.synthetic import load_asset_bank

        assets = load_asset_bank(
            args.texture_dir or os.path.join(args.output, "references", "train"),
            args.background_dir or os.path.join(args.output, "backgrounds"),
            bg_hw=(args.height, args.width),
            hdri_dir=args.hdri_dir or os.path.join(args.output, "hdris"),
            device=device,
        )
        print(f"real-asset bank: {assets.textures.shape[0]} textures, "
              f"{assets.backgrounds.shape[0]} backgrounds, "
              f"{assets.hdris.shape[0]} HDRIs")

    result = generate(args.output, {"train": args.train, "test": args.test}, args.height,
                      args.width, args.batch, device, assets, args.real_prob)
    print(f"dataset -> {args.output}/ (+ corner_annotations.json)")
    if args.derive_corners:
        from mtg_card_image_segmentation_tpu_torch.data.corners import process_dataset

        result["annotations"] = process_dataset(args.output)
        print("corner_annotations.json re-derived from masks")
    if args.yolo_output:
        from mtg_card_image_segmentation_tpu_torch.data.corners import create_yolo_annotations

        result["yolo_yaml"] = create_yolo_annotations(args.output, args.yolo_output)
        print(f"YOLO layout -> {args.yolo_output} ({result['yolo_yaml']})")
    print(json.dumps({k: v for k, v in result.items() if k != "annotations"}), flush=True)
    return result


if __name__ == "__main__":
    main()
