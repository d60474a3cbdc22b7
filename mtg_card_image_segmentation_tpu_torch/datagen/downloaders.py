"""Asset scrapers (a copy of the JAX package's ``datagen/downloaders.py``;
behavioral parity with dataset_generator/01/02/04):

- :class:`ScryfallDownloader`  — card reference scans via the Scryfall
  search API (01_download_references.py): paged search, highres-scan filter,
  25% full-art quota, train/test name dedup, 200ms rate limit, 3 retries.
- :class:`PolyhavenDownloader` — indoor HDRIs (02_dowload_hdrs.py).
- :class:`BackgroundDownloader` — Lorem Picsum random photos as negative
  samples with empty masks, resume-aware (04_random_background_downloader.py).

All network access goes through the requests-like ``session`` the caller
injects (``_HttpClient.get``); nothing here opens one. Without a session
the classes raise a clear error instead of reaching for the network (the
tests drive them with stub sessions).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

SCRYFALL_API = "https://api.scryfall.com/cards/search"
POLYHAVEN_API = "https://api.polyhaven.com"
PICSUM_URL = "https://picsum.photos"


class _HttpClient:
    """Tiny retrying HTTP wrapper (3 retries with backoff,
    01_download_references.py:66-87) around a requests-like session."""

    def __init__(self, session=None, rate_limit_s: float = 0.2, retries: int = 3):
        self.session = session
        self.rate_limit_s = rate_limit_s
        self.retries = retries
        self._last_request = 0.0

    def get(self, url: str, **kwargs):
        if self.session is None:
            raise RuntimeError(
                "no HTTP session: pass a requests-like session to the downloader"
            )
        wait = self.rate_limit_s - (time.time() - self._last_request)
        if wait > 0:
            time.sleep(wait)
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                self._last_request = time.time()
                resp = self.session.get(url, timeout=30, **kwargs)
                if resp.status_code == 200:
                    return resp
                last_err = RuntimeError(f"HTTP {resp.status_code} for {url}")
            except Exception as e:  # noqa: BLE001
                last_err = e
            time.sleep(2**attempt)
        raise RuntimeError(f"failed after {self.retries} retries: {last_err}")


class ScryfallDownloader:
    def __init__(
        self,
        output_dir: str = "references",
        train_count: int = 2000,
        test_count: int = 500,
        fullart_fraction: float = 0.25,
        session=None,
    ) -> None:
        self.output_dir = output_dir
        self.train_count = train_count
        self.test_count = test_count
        self.fullart_fraction = fullart_fraction
        self.http = _HttpClient(session)

    def search(self, query: str, max_cards: int) -> List[Dict]:
        """Paged Scryfall search, highres scans only."""
        cards: List[Dict] = []
        url = f"{SCRYFALL_API}?q={query}&unique=art"
        while url and len(cards) < max_cards:
            data = self.http.get(url).json()
            for card in data.get("data", []):
                if not card.get("highres_image"):
                    continue
                uris = card.get("image_uris") or {}
                if "large" not in uris:
                    continue
                cards.append(
                    {"name": card["name"], "url": uris["large"], "id": card["id"]}
                )
                if len(cards) >= max_cards:
                    break
            url = data.get("next_page") if data.get("has_more") else None
        return cards

    def plan(self) -> Dict[str, List[Dict]]:
        """Select train/test card sets with the full-art quota and
        name-level train/test dedup (01_download_references.py:89-103)."""
        n_full_train = int(self.train_count * self.fullart_fraction)
        n_full_test = int(self.test_count * self.fullart_fraction)
        full = self.search("is%3Afullart", n_full_train + n_full_test)
        normal = self.search(
            "-is%3Afullart+type%3Acreature",
            (self.train_count - n_full_train) + (self.test_count - n_full_test) + 500,
        )
        train = full[:n_full_train] + normal[: self.train_count - n_full_train]
        train_names = {c["name"] for c in train}
        test_pool = [
            c
            for c in full[n_full_train:] + normal[self.train_count - n_full_train :]
            if c["name"] not in train_names
        ]
        return {"train": train, "test": test_pool[: self.test_count]}

    def download(self) -> Dict[str, int]:
        counts = {}
        plan = self.plan()
        for split, cards in plan.items():
            out = os.path.join(self.output_dir, split)
            os.makedirs(out, exist_ok=True)
            done = 0
            for card in cards:
                path = os.path.join(out, f"{card['id']}.jpg")
                if os.path.exists(path):  # resume-skip
                    done += 1
                    continue
                data = self.http.get(card["url"]).content
                with open(path, "wb") as f:
                    f.write(data)
                done += 1
            counts[split] = done
        return counts


class PolyhavenDownloader:
    def __init__(self, output_dir: str = "hdris", count: int = 20,
                 resolution: str = "8k", session=None) -> None:
        self.output_dir = output_dir
        self.count = count
        self.resolution = resolution
        self.http = _HttpClient(session, rate_limit_s=0.5)

    def download(self) -> int:
        assets = self.http.get(
            f"{POLYHAVEN_API}/assets?type=hdris&categories=indoor"
        ).json()
        os.makedirs(self.output_dir, exist_ok=True)
        done = 0
        for name in list(assets)[: self.count]:
            path = os.path.join(self.output_dir, f"{name}.hdr")
            if os.path.exists(path):
                done += 1
                continue
            files = self.http.get(f"{POLYHAVEN_API}/files/{name}").json()
            url = files["hdri"][self.resolution]["hdr"]["url"]
            with open(path, "wb") as f:
                f.write(self.http.get(url).content)
            done += 1
        return done


class BackgroundDownloader:
    """Random photos as card-free negatives with empty masks."""

    def __init__(self, dataset_root: str = "dataset", train_count: int = 800,
                 test_count: int = 200, width: int = 480, height: int = 640,
                 session=None) -> None:
        self.dataset_root = dataset_root
        self.counts = {"train": train_count, "test": test_count}
        self.width = width
        self.height = height
        self.http = _HttpClient(session, rate_limit_s=0.1)

    def download(self) -> Dict[str, int]:
        import numpy as np

        done = {}
        for split, target in self.counts.items():
            img_dir = os.path.join(self.dataset_root, split, "images")
            mask_dir = os.path.join(self.dataset_root, split, "masks")
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(mask_dir, exist_ok=True)
            existing = len(
                [f for f in os.listdir(img_dir) if f.startswith("background_")]
            )
            for i in range(existing, target):  # resume-aware count
                name = f"background_{i:05d}"
                data = self.http.get(
                    f"{PICSUM_URL}/{self.width}/{self.height}"
                ).content
                with open(os.path.join(img_dir, name + ".jpg"), "wb") as f:
                    f.write(data)
                import cv2

                cv2.imwrite(
                    os.path.join(mask_dir, name + ".png"),
                    np.zeros((self.height, self.width), np.uint8),
                )
            done[split] = target
        return done
