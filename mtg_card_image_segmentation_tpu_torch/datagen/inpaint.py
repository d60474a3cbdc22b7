"""GenAI background inpainting (counterpart of the JAX package's
``datagen/inpaint.py``; parity with the reference's experimental
``dataset_generator/augmentation.py``): replace the background *behind*
the card mask of a rendered sample with generated scenery, as a diversity
augmentation for the synthetic dataset.

Two backends:

- :class:`CloudflareInpainter` — the reference's mechanism
  (augmentation.py:60-125): POST to the Cloudflare Workers AI Stable
  Diffusion v1.5 inpainting endpoint with the image, the *inverted* card
  mask (inpaint the background, keep the card), and a randomized scene
  prompt. Network access goes only through the requests-like session the
  caller injects (stub-testable).
- :func:`procedural_inpaint` — an offline fallback on the device: swaps
  the background for a freshly drawn procedural scene (the port's renderer,
  ``data/synthetic.py::background_at``) behind the masked card. Not
  diffusion, but the same dataset-level effect (background diversity with
  pixel-exact label preservation) with no external dependency.

CLI (mirrors the reference's standalone script; images are read and
written through cv2):

  python -m mtg_card_image_segmentation_tpu_torch.datagen.inpaint \\
      --image dataset/train/images/x.jpg --mask dataset/train/masks/x.png \\
      --backend procedural --output inpainted.png [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import random
from typing import List, Optional

import numpy as np
import torch

CLOUDFLARE_MODEL = "@cf/runwayml/stable-diffusion-v1-5-inpainting"

# own prompt pool, same three-part structure (subject, style, setting) as
# the reference's gen_prompt (augmentation.py:14-46)
_SUBJECTS = [
    "a trading card lying on a table",
    "a collectible card held between two fingers",
    "a game card resting on a play mat",
    "a card propped against a stack of deck boxes",
    "a single card under soft window light",
    "a card at the edge of a tournament table",
]
_STYLES = [
    "photorealistic",
    "shallow depth of field",
    "studio product photography",
    "natural indoor lighting",
]
_SETTINGS = [
    "on green felt",
    "on dark wood grain",
    "on a marble slab",
    "in a cluttered hobby room",
    "in a dim card shop",
    "on a glass display case",
    "next to scattered dice",
    "with bookshelves behind",
]


def random_prompt(rng: Optional[random.Random] = None) -> str:
    r = rng or random
    return ", ".join(
        (r.choice(_SUBJECTS), r.choice(_STYLES), r.choice(_SETTINGS))
    )


def _png_int_array(path_or_array, invert: bool = False) -> List[int]:
    """Encode an image file/array as the uint8 PNG byte list the Workers AI
    REST API consumes (augmentation.py:49-57): an (H, W, 3) array is RGB,
    ``invert`` turns it into the inverted gray mask."""
    import cv2

    if isinstance(path_or_array, (str, os.PathLike)):
        img = cv2.imread(os.fspath(path_or_array), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path_or_array)
        if img.ndim == 3:  # cv2 reads BGR
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    else:
        img = np.asarray(path_or_array, np.uint8)
    if invert:
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if img.ndim == 3 else img
        img = 255 - gray
    elif img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(".png", img)
    if not ok:
        raise ValueError("PNG encoding failed")
    return list(buf.tobytes())


class CloudflareInpainter:
    """Workers AI SD-1.5 inpainting client (augmentation.py:60-125).

    ``session`` is any requests-like object with ``.post``, which the
    caller injects (a stub in tests); without one the call raises.
    Credentials come from args or the ``CLOUDFLARE_ACCOUNT_ID`` /
    ``CLOUDFLARE_API_TOKEN`` env vars.
    """

    def __init__(
        self,
        account_id: Optional[str] = None,
        api_token: Optional[str] = None,
        session=None,
        num_steps: int = 20,
        guidance: float = 7.5,
        retries: int = 3,
    ) -> None:
        self.account_id = account_id or os.environ.get("CLOUDFLARE_ACCOUNT_ID")
        self.api_token = api_token or os.environ.get("CLOUDFLARE_API_TOKEN")
        self.session = session
        self.num_steps = num_steps
        self.guidance = guidance
        self.retries = retries

    @property
    def url(self) -> str:
        return (
            f"https://api.cloudflare.com/client/v4/accounts/"
            f"{self.account_id}/ai/run/{CLOUDFLARE_MODEL}"
        )

    def inpaint_background(
        self,
        image,
        mask,
        prompt: Optional[str] = None,
        height: int = 640,
        width: int = 480,
        seed: Optional[int] = None,
    ) -> bytes:
        """Replace everything OUTSIDE the card mask. ``image``/``mask`` are
        paths or uint8 arrays; the mask is inverted before the call because
        the API paints where the mask is white (augmentation.py:97)."""
        if self.session is None:
            raise RuntimeError("no HTTP session: pass a requests-like session")
        if not (self.account_id and self.api_token):
            raise RuntimeError(
                "Cloudflare credentials missing: set CLOUDFLARE_ACCOUNT_ID "
                "and CLOUDFLARE_API_TOKEN"
            )
        payload = {
            "image": _png_int_array(image),
            "mask": _png_int_array(mask, invert=True),
            "prompt": prompt or random_prompt(),
            "height": height,
            "width": width,
            "num_steps": self.num_steps,
            "strength": 1,
            "guidance": self.guidance,
        }
        if seed is not None:
            payload["seed"] = int(seed)
        headers = {
            "Authorization": f"Bearer {self.api_token}",
            "Content-Type": "application/json",
        }
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                resp = self.session.post(
                    self.url, json=payload, headers=headers, timeout=120
                )
                if resp.status_code == 200:
                    return resp.content
                last_err = RuntimeError(f"HTTP {resp.status_code}: {resp.text[:200]}")
            except Exception as e:  # noqa: BLE001
                last_err = e
            import time

            time.sleep(2**attempt)
        raise RuntimeError(f"inpainting failed after {self.retries} tries: {last_err}")


def procedural_inpaint(image, mask, seed: int = 0, device=None):
    """Offline background replacement: draw a fresh procedural background
    with the port's renderer (``data/synthetic.py::background_at``, one
    scene from a ``torch.Generator`` seeded with ``seed``) on ``device``
    (default: the CUDA card) and composite the masked card over it.

    image: (H, W, 3) uint8; mask: (H, W) uint8/bool (card=nonzero); numpy
    arrays or tensors. Returns (H, W, 3) uint8 with the identical card
    pixels and a new background (labels stay exactly valid): a tensor on
    ``device`` for tensor inputs, else a numpy array.
    """
    from mtg_card_image_segmentation_tpu_torch.data import warp as W
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import background_at, draw_scene
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    as_numpy = not torch.is_tensor(image)
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image) if as_numpy else image).to(dev)
    m = torch.as_tensor(np.asarray(mask) if as_numpy else mask).to(dev)
    h, w = m.shape[:2]
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = draw_scene(gen, 1, h, w, 0.0)
    gy, gx = W.identity_grid(h, w, dev)
    bg = background_at(d, gy.expand(1, h, w), gx.expand(1, h, w), h, w)[0]
    bg_u8 = torch.clamp(bg * 255.0, 0, 255).to(torch.uint8)
    out = torch.where((m > 0)[..., None], img.to(torch.uint8), bg_u8)
    return out.cpu().numpy() if as_numpy else out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image", required=True)
    parser.add_argument("--mask", required=True)
    parser.add_argument("--output", default="inpainted.png")
    parser.add_argument("--backend", choices=["cloudflare", "procedural"],
                        default="procedural")
    parser.add_argument("--prompt", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="procedural: cuda (default) or cpu")
    args = parser.parse_args(argv)

    import cv2

    if args.backend == "cloudflare":
        import requests

        out = CloudflareInpainter(session=requests.Session()).inpaint_background(
            args.image, args.mask, prompt=args.prompt, seed=args.seed
        )
        with open(args.output, "wb") as f:
            f.write(out)
    else:
        img = cv2.cvtColor(cv2.imread(args.image, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        mask = cv2.imread(args.mask, cv2.IMREAD_GRAYSCALE)
        out = procedural_inpaint(img, mask, seed=args.seed or 0, device=args.device)
        cv2.imwrite(args.output, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
    print(f"inpainted ({args.backend}) -> {args.output}")


if __name__ == "__main__":
    main()
