"""The port's copies of the JAX package's framework-free surfaces, held
against their originals on the same inputs: the augmentation policies and
TTA (``data/aug_policies.py``), the mask-to-corners derivation and the
YOLO layout writer (``data/corners.py``), the watchdog, the downloaders and
the inpainter (``datagen/*``, with the stub sessions of
``tests/test_datagen.py``: no test makes a live request), and
``procedural_inpaint`` on the port's renderer."""

import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.data import aug_policies as jax_pol
from mtg_card_image_segmentation_tpu.data import corners as jax_corners
from mtg_card_image_segmentation_tpu.datagen import downloaders as jax_dl
from mtg_card_image_segmentation_tpu.datagen import inpaint as jax_inpaint

from mtg_card_image_segmentation_tpu_torch.data import aug_policies as pol
from mtg_card_image_segmentation_tpu_torch.data import corners
from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch
from mtg_card_image_segmentation_tpu_torch.datagen import downloaders as dl
from mtg_card_image_segmentation_tpu_torch.datagen import inpaint
from mtg_card_image_segmentation_tpu_torch.datagen.watchdog import run_with_watchdog

cv2 = pytest.importorskip("cv2")


# --------------------------------------------------------------------------
# augmentation policies and TTA
# --------------------------------------------------------------------------


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", sorted(jax_pol.POLICIES))
def test_policies_equal_the_jax_tables_field_for_field(name):
    assert set(pol.POLICIES) == set(jax_pol.POLICIES)
    assert _fields(pol.POLICIES[name]) == _fields(jax_pol.POLICIES[name])
    assert pol.DEFAULT_WEIGHTS == jax_pol.DEFAULT_WEIGHTS
    assert tuple(pol.TTA_TRANSFORMS) == tuple(jax_pol.TTA_TRANSFORMS)


def test_choose_policy_and_the_schedules_pick_as_jax_does():
    """The same numpy seed picks the same policies; the step schedule and
    the blended configs equal JAX's at every epoch."""
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    assert [pol.choose_policy(a) for _ in range(200)] == \
        [jax_pol.choose_policy(b) for _ in range(200)]
    w = {"heavy": 2.0, "color": 1.0}
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    assert [pol.choose_policy(a, w) for _ in range(50)] == \
        [jax_pol.choose_policy(b, w) for _ in range(50)]
    for epoch in range(0, 101, 5):
        assert pol.progressive_policy(epoch, 100) == jax_pol.progressive_policy(epoch, 100)
        assert _fields(pol.progressive_config(epoch, 100)) == \
            _fields(jax_pol.progressive_config(epoch, 100))


def test_tta_batch_and_merge_match_jax():
    """Every TTA transform within 1e-6 of JAX's on the same [0,1] batch; the
    merge un-flips and averages as JAX's does."""
    x = np.random.default_rng(0).random((2, 24, 20, 3)).astype(np.float32)
    got = pol.tta_batch(torch.from_numpy(x))
    want = jax_pol.tta_batch(jnp.asarray(x))
    assert list(got) == list(want) == list(pol.TTA_TRANSFORMS)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    logits = {k: np.random.default_rng(i).random((2, 24, 20, 2)).astype(np.float32)
              for i, k in enumerate(pol.TTA_TRANSFORMS)}
    merged = pol.tta_merge_masks({k: torch.from_numpy(v) for k, v in logits.items()})
    ref = jax_pol.tta_merge_masks({k: jnp.asarray(v) for k, v in logits.items()})
    np.testing.assert_allclose(merged.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# corners
# --------------------------------------------------------------------------


def _renders(n: int, h: int, w: int, seed: int):
    s = synthetic_batch(torch.Generator().manual_seed(seed), n, h, w, 0.0)
    return ((s.image.numpy() * 255).astype(np.uint8), s.mask.numpy().astype(np.uint8) * 255,
            s.corners.numpy())


def test_order_and_find_corners_equal_the_original_on_renderer_masks():
    """On the port renderer's masks the copy derives the original's corners
    exactly, and they lie within 6 px of the renderer's quads (as a point
    cycle) on all but one in-frame scene."""
    _, masks, gt = _renders(8, 160, 120, 0)
    hits = total = 0
    for m, q in zip(masks, gt):
        got, want = corners.find_card_corners(m), jax_corners.find_card_corners(m)
        assert (got is None) == (want is None)
        if got is None:
            continue
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(corners.order_corners(q), jax_corners.order_corners(q))
        in_frame = ((q[:, 0] >= 2) & (q[:, 0] <= 117) & (q[:, 1] >= 2) & (q[:, 1] <= 157)).all()
        if in_frame:
            total += 1
            err = min(float(np.abs(got - np.roll(c, r, axis=0)).max())
                      for c in (q, q[::-1]) for r in range(4))
            hits += err < 6.0
    assert total >= 2 and hits >= total - 1
    assert corners.find_card_corners(np.zeros((64, 64), np.uint8)) is None


def _dataset(root, seed: int = 3):
    imgs, masks, _ = _renders(3, 96, 72, seed)
    for split, idx in (("train", (0, 1)), ("test", (2,))):
        os.makedirs(root / split / "images")
        os.makedirs(root / split / "masks")
        for i in idx:
            cv2.imwrite(str(root / split / "images" / f"img_{i}.jpg"),
                        cv2.cvtColor(imgs[i], cv2.COLOR_RGB2BGR))
            cv2.imwrite(str(root / split / "masks" / f"img_{i}.png"), masks[i])


def test_process_dataset_and_yolo_layout_equal_the_originals(tmp_path):
    """``process_dataset`` writes the original's corner_annotations.json
    (JSON equal) and ``create_yolo_annotations`` its labels and data.yaml
    (byte equal, the yaml's absolute root aside)."""
    for which in ("port", "jax"):
        _dataset(tmp_path / which)
    ann = corners.process_dataset(str(tmp_path / "port"))
    ref = jax_corners.process_dataset(str(tmp_path / "jax"))
    assert ann == ref and len(ann["train"]) >= 1
    assert json.loads((tmp_path / "port" / "corner_annotations.json").read_text()) == \
        json.loads((tmp_path / "jax" / "corner_annotations.json").read_text())
    y_port = corners.create_yolo_annotations(str(tmp_path / "port"), str(tmp_path / "yp"))
    y_jax = jax_corners.create_yolo_annotations(str(tmp_path / "jax"), str(tmp_path / "yj"))
    assert open(y_port).read().replace(str(tmp_path / "yp"), "R") == \
        open(y_jax).read().replace(str(tmp_path / "yj"), "R")
    for split in ("train", "test"):
        names = sorted(os.listdir(tmp_path / "yj" / split / "labels"))
        assert names and sorted(os.listdir(tmp_path / "yp" / split / "labels")) == names
        for n in names:
            assert (tmp_path / "yp" / split / "labels" / n).read_bytes() == \
                (tmp_path / "yj" / split / "labels" / n).read_bytes()


# --------------------------------------------------------------------------
# datagen: watchdog, downloaders, inpainting
# --------------------------------------------------------------------------


def test_watchdog_restarts_then_succeeds(tmp_path):
    """A run past the limit is killed and restarted; the next, under the
    limit, ends it with exit code 0."""
    flag = tmp_path / "ran"
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys, time\n"
        f"flag = {str(flag)!r}\n"
        "if os.path.exists(flag):\n"
        "    sys.exit(0)\n"
        "open(flag, 'w').write('x')\n"
        "time.sleep(60)\n"
    )
    logs = []
    code = run_with_watchdog([sys.executable, "-S", str(script)], timeout_minutes=5 / 60,
                             grace_seconds=1, max_restarts=3, log=logs.append)
    assert code == 0
    assert any("restarting" in m for m in logs)


class _StubResponse:
    def __init__(self, payload=None, content=b"x"):
        self.status_code = 200
        self._payload = payload
        self.content = content

    def json(self):
        return self._payload


class _StubSession:
    """Offline Scryfall/Polyhaven/Picsum stub (``tests/test_datagen.py``'s
    Scryfall pages, plus the two other sites)."""

    def __init__(self):
        self.calls = []

    def get(self, url, timeout=None, **kw):
        self.calls.append(url)
        if "cards/search" in url:
            page2 = "page2" in url
            kind = "n" if "-is%3Afullart" in url else "f"
            data = [{"name": f"Card {kind}{i}{page2}", "id": f"id_{kind}{i}{page2}",
                     "highres_image": True, "image_uris": {"large": f"http://img/{i}"}}
                    for i in range(5)]
            return _StubResponse({"data": data, "has_more": not page2,
                                  "next_page": url + "&page2"})
        if url.endswith("categories=indoor"):
            return _StubResponse({f"hdri_{i}": {} for i in range(3)})
        if "/files/" in url:
            return _StubResponse({"hdri": {"8k": {"hdr": {"url": url + ".hdr"}}}})
        return _StubResponse(content=b"JPEGDATA")


def _run_downloaders(mod, root) -> tuple:
    sess = _StubSession()
    counts = mod.ScryfallDownloader(str(root / "refs"), train_count=6, test_count=2,
                                    session=sess).download()
    again = mod.ScryfallDownloader(str(root / "refs"), train_count=6, test_count=2,
                                   session=sess).download()
    hdris = mod.PolyhavenDownloader(str(root / "hdris"), count=2, session=sess).download()
    bgs = mod.BackgroundDownloader(str(root / "ds"), train_count=2, test_count=1, width=8,
                                   height=6, session=sess).download()
    files = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    return counts, again, hdris, bgs, files, sess.calls


def test_downloaders_with_stub_sessions_do_what_the_originals_do(tmp_path, monkeypatch):
    """Scryfall (plan, dedup, resume), Polyhaven and Picsum through a stub
    session: the same counts, files and request sequence as the originals;
    without a session the client raises before any request."""
    monkeypatch.setattr(dl.time, "sleep", lambda s: None)
    monkeypatch.setattr(jax_dl.time, "sleep", lambda s: None)
    got = _run_downloaders(dl, tmp_path / "port")
    want = _run_downloaders(jax_dl, tmp_path / "jax")
    assert got == want
    counts, again = got[0], got[1]
    assert counts["train"] == 6 and counts["test"] == 2 and again == counts
    client = dl._HttpClient(session=None)
    with pytest.raises(RuntimeError, match="no HTTP session"):
        client.get("http://example.com")


class _InpaintStubSession:
    """Offline Workers AI stub: records the payload, returns PNG-ish bytes."""

    def __init__(self):
        self.payloads = []

    def post(self, url, json=None, headers=None, timeout=None):
        self.payloads.append({"url": url, "json": json, "headers": headers})
        return _StubResponse(content=b"\x89PNG-generated")


def test_cloudflare_inpainter_sends_the_originals_request():
    """The payload of ``tests/test_datagen.py``'s stub: image and inverted
    mask as PNG byte lists (decoding to the original's pixels), the seed,
    a three-part prompt, bearer auth, the same URL; no session raises."""
    img = np.zeros((8, 8, 3), np.uint8) + np.array([200, 100, 50], np.uint8)
    mask = np.zeros((8, 8), np.uint8)
    mask[2:6, 2:6] = 255
    bodies = []
    for mod in (inpaint, jax_inpaint):
        sess = _InpaintStubSession()
        ip = mod.CloudflareInpainter(account_id="acct", api_token="tok", session=sess)
        assert ip.inpaint_background(img, mask, prompt="p", seed=7).startswith(b"\x89PNG")
        bodies.append(sess.payloads[0])
    got, want = bodies
    assert got["url"] == want["url"] and got["headers"] == want["headers"]
    for k in ("prompt", "seed", "height", "width", "num_steps", "strength", "guidance"):
        assert got["json"][k] == want["json"][k]
    from PIL import Image

    for k in ("image", "mask"):
        a = cv2.imdecode(np.frombuffer(bytes(got["json"][k]), np.uint8), cv2.IMREAD_UNCHANGED)
        b = np.asarray(Image.open(io.BytesIO(bytes(want["json"][k]))))
        if a.ndim == 3:
            a = cv2.cvtColor(a, cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert inpaint.random_prompt().count(",") == 2
    with pytest.raises(RuntimeError, match="no HTTP session"):
        inpaint.CloudflareInpainter(account_id="a", api_token="t").inpaint_background(img, mask)


def test_procedural_inpaint_keeps_the_card_and_replaces_the_background():
    """The card's pixels stay exactly, the background is the port
    renderer's; tensors in give tensors out on their device, and the same
    seed draws the same background."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (32, 24, 3), np.uint8)
    mask = np.zeros((32, 24), np.uint8)
    mask[8:20, 6:18] = 1
    out = inpaint.procedural_inpaint(img, mask, seed=1, device="cpu")
    assert out.shape == img.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out[mask > 0], img[mask > 0])
    assert (out[mask == 0] != img[mask == 0]).mean() > 0.9
    t = inpaint.procedural_inpaint(torch.from_numpy(img), torch.from_numpy(mask), seed=1,
                                   device="cpu")
    assert torch.is_tensor(t) and np.array_equal(t.numpy(), out)


def test_inpaint_cli_reads_and_writes_through_cv2(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (16, 12, 3), np.uint8)
    mask = np.zeros((16, 12), np.uint8)
    mask[4:12, 3:9] = 255
    cv2.imwrite(str(tmp_path / "x.png"), img)
    cv2.imwrite(str(tmp_path / "m.png"), mask)
    inpaint.main(["--image", str(tmp_path / "x.png"), "--mask", str(tmp_path / "m.png"),
                  "--output", str(tmp_path / "o.png"), "--device", "cpu"])
    out = cv2.imread(str(tmp_path / "o.png"))
    np.testing.assert_array_equal(out[mask > 0], img[mask > 0])
