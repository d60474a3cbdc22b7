"""The port's data pipeline against the JAX package's, on the CPU:
``preprocess_batch``, the ``dataset.py`` copy, ``load_asset_bank``,
``FilePipeline`` (same numpy shuffle order, same batches), the draws'
moments, the rendered stream's statistics, and the ``train_seg_torch.py``
CLI end to end at 64x48 b2.

Tolerances: images max|d| <= 1e-5, masks and ``valid`` exact; a Bernoulli
rate within 4 sigma of its probability over 4,096 draws, a uniform inside
its range with its mean within 4 sigma of the middle.
"""

import json
import math
import os
import threading

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.config import AugmentConfig as JaxAugmentConfig
from mtg_card_image_segmentation_tpu.data import dataset as jds
from mtg_card_image_segmentation_tpu.data import pipeline as jpipe
from mtg_card_image_segmentation_tpu.data import synthetic as jsyn
from mtg_card_image_segmentation_tpu.data.preprocess import preprocess_batch as jax_preprocess

import train_seg_torch
from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
from mtg_card_image_segmentation_tpu_torch.data import augment as A
from mtg_card_image_segmentation_tpu_torch.data import dataset as pds
from mtg_card_image_segmentation_tpu_torch.data import synthetic as S
from mtg_card_image_segmentation_tpu_torch.data.pipeline import FilePipeline, SyntheticPipeline
from mtg_card_image_segmentation_tpu_torch.data.preprocess import preprocess_batch
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

torch.set_num_threads(2)

H, W = 64, 48
NDRAWS = 4096


def n(x):
    return x.detach().cpu().numpy()


def _write_split(root, split, count, hw, seed, odd_size=None):
    """``count`` JPEG frames with PNG masks (a bright rectangle) under
    ``root/split/{images,masks}``; frame ``odd_size[0]`` gets size
    ``odd_size[1]``, and one image has no mask."""
    r = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, split, "masks"), exist_ok=True)
    for i in range(count):
        h, w = odd_size[1] if odd_size and i == odd_size[0] else hw
        img = (r.random((h, w, 3)) * 255).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        y0, x0 = r.integers(0, h // 2), r.integers(0, w // 2)
        mask[y0:y0 + h // 3, x0:x0 + w // 3] = 255
        img[mask > 0] //= 3
        cv2.imwrite(os.path.join(root, split, "images", f"f{i:03d}.jpg"), img[..., ::-1])
        cv2.imwrite(os.path.join(root, split, "masks", f"f{i:03d}.png"), mask)
    cv2.imwrite(os.path.join(root, split, "images", "nomask.png"),
                np.zeros((hw[0], hw[1], 3), np.uint8))


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    _write_split(root, "train", 9, (40, 56), 0, odd_size=(4, (36, 50)))
    _write_split(root, "test", 5, (40, 56), 1)
    return root


# --------------------------------------------------------------------------
# preprocess_batch, dataset.py, load_asset_bank


@pytest.mark.parametrize("size,normalize", [((64, 48), True), ((30, 20), False),
                                            ((64, 48), False)])
def test_preprocess_batch_matches_jax(size, normalize):
    r = np.random.default_rng(3)
    imgs = r.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    masks = r.integers(0, 256, (3, 40, 56), dtype=np.uint8)
    ref_x, ref_m = jax_preprocess(imgs, masks, size[0], size[1], normalize)
    x, m = preprocess_batch(torch.from_numpy(imgs), torch.from_numpy(masks), *size, normalize)
    np.testing.assert_allclose(n(x), np.asarray(ref_x), atol=1e-5)
    assert m.dtype == torch.int32 and np.array_equal(n(m), np.asarray(ref_m))
    only = preprocess_batch(torch.from_numpy(imgs), None, *size, normalize)
    np.testing.assert_allclose(n(only), np.asarray(jax_preprocess(imgs, None, *size, normalize)),
                               atol=1e-5)


def test_dataset_copy_equals_the_original(dataset_root, tmp_path):
    img_dir = os.path.join(dataset_root, "train", "images")
    mask_dir = os.path.join(dataset_root, "train", "masks")
    a, b = pds.CardSegmentationDataset(img_dir, mask_dir), jds.CardSegmentationDataset(img_dir,
                                                                                       mask_dir)
    assert a.items == b.items and len(a) == 9
    for i in range(len(a)):
        for x, y in zip(a.load_raw(i), b.load_raw(i)):
            assert np.array_equal(x, y)
    ann = {"train": {"f000.jpg": [[1, 2], [30, 2], [30, 20], [1, 20]], "f001.jpg": [[1, 2]],
                     "missing.jpg": [[0, 0]] * 4}}
    path = tmp_path / "corner_annotations.json"
    path.write_text(json.dumps(ann))
    assert pds.load_corner_annotations(str(path)) == jds.load_corner_annotations(str(path))
    ca, cb = pds.CornerDataset(img_dir, ann["train"]), jds.CornerDataset(img_dir, ann["train"])
    assert len(ca) == len(cb) == 1
    for x, y in zip(ca.load_raw(0), cb.load_raw(0)):
        assert np.array_equal(x, y)
    with pytest.raises(FileNotFoundError):
        pds.CardSegmentationDataset(str(tmp_path), str(tmp_path))


def test_load_asset_bank_matches_jax(tmp_path):
    r = np.random.default_rng(4)
    for kind, count, shape in (("tex", 2, (50, 40)), ("bg", 3, (30, 44)), ("hdr", 2, (20, 40))):
        d = tmp_path / kind / "sub"
        d.mkdir(parents=True)
        for i in range(count):
            if kind == "hdr":
                cv2.imwrite(str(d / f"e{i}.hdr"), (r.random(shape + (3,)) * 4).astype(np.float32))
            else:
                cv2.imwrite(str(d / f"a{i}.png"), (r.random(shape + (3,)) * 255).astype(np.uint8))
    args = (str(tmp_path / "tex"), str(tmp_path / "bg"))
    kw = dict(tex_hw=(22, 16), bg_hw=(24, 32), hdri_dir=str(tmp_path / "hdr"), hdri_hw=(8, 16))
    ref = jsyn.load_asset_bank(*args, **kw)
    got = S.load_asset_bank(*args, device="cpu", **kw)
    for name in S.AssetBank._fields:
        a, b = n(getattr(got, name)), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.shape[0] > 0, name
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
    empty = S.load_asset_bank(None, str(tmp_path / "nothing"), device="cpu")
    assert empty.textures.shape[0] == 0 and empty.backgrounds.shape[0] == 0


# --------------------------------------------------------------------------
# FilePipeline


def _datasets(root, split="train"):
    d = (os.path.join(root, split, "images"), os.path.join(root, split, "masks"))
    return pds.CardSegmentationDataset(*d), jds.CardSegmentationDataset(*d)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_file_pipeline_matches_jax(dataset_root, shuffle, drop_last):
    """Same order (numpy shuffle, two epochs), batches, masks and valid
    counts; the tail batch padded when it is kept."""
    pds_, jds_ = _datasets(dataset_root)
    port = FilePipeline(pds_, 4, H, W, shuffle=shuffle, drop_last=drop_last, seed=7, device="cpu")
    ref = jpipe.FilePipeline(jds_, 4, H, W, shuffle=shuffle, drop_last=drop_last, seed=7)
    assert port.steps_per_epoch == ref.steps_per_epoch == (2 if drop_last else 3)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == port.steps_per_epoch
        for (x, m, v), (jx, jm, jv) in zip(got, want):
            assert v == jv
            np.testing.assert_allclose(n(x), np.asarray(jx), atol=1e-5)
            assert np.array_equal(n(m), np.asarray(jm))
    if not drop_last:  # 9 = 4 + 4 + 1: the last batch is one real image + padding
        assert got[-1][2] == 1 and int(got[-1][1][1:].abs().sum()) == 0


def test_file_pipeline_disabled_augment_quirk_matches_jax(dataset_root):
    """An ``AugmentConfig(enabled=False)`` gives un-normalized [0, 1]
    images in both packages (the reference's behaviour, kept)."""
    pds_, jds_ = _datasets(dataset_root)
    off = AugmentConfig(enabled=False)
    (x, m, _), = list(FilePipeline(pds_, 8, H, W, augment=off, seed=1, device="cpu"))
    (jx, jm, _), = list(jpipe.FilePipeline(jds_, 8, H, W,
                                           augment=JaxAugmentConfig(enabled=False), seed=1))
    np.testing.assert_allclose(n(x), np.asarray(jx), atol=1e-5)
    assert np.array_equal(n(m), np.asarray(jm))
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


def test_file_pipeline_augments_on_the_consuming_thread_and_stops(dataset_root):
    """With augmentation the batches are normalized and the masks stay
    {0,1}; the prefetch thread ends when the iterator is closed early, and
    a decode error reaches the consumer."""
    pds_, _ = _datasets(dataset_root)
    pipe = FilePipeline(pds_, 2, H, W, augment=AugmentConfig(), seed=2, prefetch=1, device="cpu")
    before = threading.active_count()
    it = iter(pipe)
    x, m, v = next(it)
    assert x.shape == (2, H, W, 3) and float(x.min()) < 0.0 and set(n(m).ravel()) <= {0, 1}
    it.close()
    assert threading.active_count() == before
    pds_.items[0] = ("/nonexistent.jpg", pds_.items[0][1])
    with pytest.raises(IOError):
        list(FilePipeline(pds_, 2, H, W, shuffle=False, device="cpu"))


# --------------------------------------------------------------------------
# draws' moments, the rendered stream


def _rate_ok(x, p):
    rate = float(x.float().mean())
    sigma = math.sqrt(p * (1 - p) / x.numel()) if 0 < p < 1 else 0.0
    return abs(rate - p) <= 4 * sigma + 1e-12, rate


def _uniform_ok(x, lo, hi):
    x = x.double()
    sigma = (hi - lo) / math.sqrt(12 * x.numel())
    return (float(x.min()) >= lo and float(x.max()) < hi
            and abs(float(x.mean()) - (lo + hi) / 2) <= 4 * sigma)


def test_augment_draws_moments():
    cfg = AugmentConfig()
    d = A.draw_augment(torch.Generator().manual_seed(0), NDRAWS, 2, 3, cfg)
    g, dsp, c = d
    for x, p in ((g.do_flip, cfg.hflip_prob), (g.do_affine, cfg.affine_prob),
                 (dsp.do_elastic, cfg.elastic_prob), (dsp.do_grid, cfg.grid_distort_prob),
                 (c.do_jitter, cfg.color_jitter_prob), (c.do_bc, cfg.brightness_contrast_prob),
                 (c.do_noise_blur, cfg.noise_blur_prob), (c.pick_noise, 0.5)):
        ok, rate = _rate_ok(x, p)
        assert ok, (p, rate)
    tp, lim, gl = cfg.translate_percent, cfg.rotate_limit_deg, cfg.grid_distort_limit
    for x, (lo, hi) in ((g.translate, (-tp, tp)), (g.scale, cfg.scale_range),
                        (g.angle_deg, (-lim, lim)), (dsp.noise_y, (-1.0, 1.0)),
                        (dsp.grid_x, (-gl, gl)), (c.brightness, (-cfg.brightness, cfg.brightness)),
                        (c.hue, (-cfg.hue, cfg.hue)), (c.noise_std, cfg.noise_std_range),
                        (c.blur_sigma, cfg.blur_sigma_range)):
        assert _uniform_ok(x, lo, hi), (lo, hi)
    z = c.noise.double()
    assert abs(float(z.mean())) < 4 / math.sqrt(z.numel()) and abs(float(z.std()) - 1) < 0.01
    assert A.draw_augment(torch.Generator(), 2, 2, 3, cfg, keypoints=True).displacement is None


@pytest.mark.parametrize("keep_in_frame", [False, True])
def test_scene_draws_moments(keep_in_frame):
    _, bank = _bank_pair()
    d = S.draw_scene(torch.Generator().manual_seed(1), NDRAWS, 2, 3, 0.09, bank, 0.7,
                     keep_in_frame)
    for x, p in ((~d.has_card, 0.09), (d.use_real_bg, 0.7), (d.use_hdri_bg, 0.35),
                 (d.use_real_tex, 0.7)):
        ok, rate = _rate_ok(x, p)
        assert ok, (p, rate)
    for x, (lo, hi) in ((d.scale, (0.35, 0.72 if keep_in_frame else 0.95)),
                        (d.angle, (0.0, 2 * math.pi)), (d.pos, (-0.2, 0.2)),
                        (d.persp, (-0.06, 0.06)), (d.bg_freq, (1.0, 8.0)),
                        (d.text_col, (0.7, 0.95)), (d.exposure, (0.85, 1.15)),
                        (d.light_strength, (0.8, 1.5)), (d.hdri_rot, (0.0, 1.0))):
        assert _uniform_ok(x, lo, hi), (lo, hi)
    for idx, count in ((d.bg_index, 3), (d.tex_index, 2), (d.hdri_index, 2)):
        assert set(idx.tolist()) == set(range(count))


def _bank_pair():
    r = np.random.default_rng(5)
    arrs = [r.random(s).astype(np.float32) for s in
            ((2, 22, 16, 3), (3, 30, 40, 3), (2, 8, 16, 3), (2, 16, 32, 3))]
    return (jsyn.AssetBank(*(jnp.asarray(a) for a in arrs)),
            S.AssetBank(*(torch.from_numpy(a) for a in arrs)))


def test_rendered_stream_statistics_match_jax():
    """The training stream (rendered + augmented, 256 samples) in both
    packages: negative share within 0.1 (4 sigma of the difference of two
    binomial shares at p = 0.09), mean foreground share within 0.05 (over 10
    standard errors of either mean, measured 0.13-0.14 per sample std)."""
    b = 256
    port = SyntheticPipeline(b, H, W, seed=3, device="cpu").next_batch()
    ref = next(iter(jpipe.SyntheticPipeline(b, H, W, seed=3)))
    fg_p = n(port[1]).mean(axis=(1, 2))
    fg_j = np.asarray(ref[1]).mean(axis=(1, 2))
    neg_p, neg_j = (fg_p == 0).mean(), (fg_j == 0).mean()
    assert abs(neg_p - neg_j) <= 0.1, (neg_p, neg_j)
    assert abs(fg_p.mean() - fg_j.mean()) <= 0.05, (fg_p.mean(), fg_j.mean())
    # normalized like the JAX stream
    assert abs(float(port[0].mean()) - float(ref[0].mean())) <= 0.15
    assert port[1].dtype == torch.int32


def test_pipelines_and_bank_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        SyntheticPipeline(2, H, W)
    with pytest.raises(RuntimeError):
        train_seg_torch.main(["--set", "train.num_epochs=1"])


# --------------------------------------------------------------------------
# the CLI


def _cli_args(root, source, epochs, extra=()):
    sets = [f"model.input_height={H}", f"model.input_width={W}", "data.batch_size=2",
            f"train.num_epochs={epochs}", "train.log_every_steps=1",
            "train.save_every_epochs=1", f"train.checkpoint_dir={root}/ckpt_{source}",
            f"train.log_dir={root}/logs", *extra]
    return ["--source", source, "--device", "cpu", "--set", *sets]


def test_train_seg_cli_synthetic_resume_and_serve(tmp_path):
    hist = train_seg_torch.main(_cli_args(tmp_path, "synthetic", 1, ["train.steps_per_epoch=2"]))
    assert len(hist["train_loss"]) == 1 and len(hist["val_mean_iou"]) == 1
    ckpt = tmp_path / "ckpt_synthetic"
    assert (ckpt / "final_model").is_dir() and (ckpt / "checkpoint_epoch_1").is_dir()
    hist2 = train_seg_torch.main(_cli_args(tmp_path, "synthetic", 2, ["train.steps_per_epoch=2"])
                                 + ["--resume"])
    assert len(hist2["train_loss"]) == 2 and hist2["train_loss"][0] == hist["train_loss"][0]
    pred = SegPredictor.from_checkpoint(str(ckpt), "final_model", H, W, device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (2, H, W, 3), np.uint8)
    masks = pred.predict(imgs)
    assert masks.shape == (2, H, W) and masks.dtype == torch.uint8


def test_train_seg_cli_files(dataset_root, tmp_path):
    hist = train_seg_torch.main(_cli_args(tmp_path, "files", 1,
                                          [f"data.dataset_root={dataset_root}"]))
    # the epoch follows the dataset: 9 pairs // 2 = 4 steps
    assert len(hist["train_loss"]) == 1 and 0.0 <= hist["val_mean_iou"][0] <= 1.0
    assert (tmp_path / "ckpt_files" / "final_model").is_dir()
    SegPredictor.from_checkpoint(str(tmp_path / "ckpt_files"), "final_model", H, W, device="cpu")

