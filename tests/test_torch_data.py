"""The port's data path (``data/warp.py``, ``data/augment.py``,
``data/synthetic.py``) against the JAX package's on the CPU, at 64x48, b2-b4.

JAX random streams cannot be reproduced in torch, so the port splits every
random function into ``draw_*`` and a pure function of the draws. Here the
draws are taken from a JAX key by repeating the JAX function's own
``split``/``fold_in`` sequence and distribution calls (the ``_jax_*_draws``
helpers below), given to the port, and the same key goes to the JAX
function (under ``jax.jit``).

Tolerances: images max|d| <= 1e-4 on [0, 1]; the warps <= 1e-5 (coordinate
maps relative, their values reach 64); the DLT solve <= 1e-4 relative;
nearest warps and masks exact, except where a float path decides the mask
(the renderer's ``alpha > 0.5``, the warped grid's ``round``): agreement
>= 0.9995 there.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.config import AugmentConfig as JaxAugmentConfig
from mtg_card_image_segmentation_tpu.data import augment as jaug
from mtg_card_image_segmentation_tpu.data import synthetic as jsyn
from mtg_card_image_segmentation_tpu.data import warp as jwarp

from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
from mtg_card_image_segmentation_tpu_torch.data import augment as A
from mtg_card_image_segmentation_tpu_torch.data import synthetic as S
from mtg_card_image_segmentation_tpu_torch.data import warp as W

torch.set_num_threads(2)

H, W_ = 64, 48
IMG_TOL = 1e-4
MASK_AGREE = 0.9995


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().cpu().numpy()


def _rng(seed):
    return np.random.default_rng(seed)


def _jcfg(cfg: AugmentConfig) -> JaxAugmentConfig:
    return JaxAugmentConfig(**dataclasses.asdict(cfg))


# --------------------------------------------------------------------------
# draws mirrored from a JAX key


def _jax_geometry_draws(k_geo, cfg):
    k_flip, k_p_aff, k_tr, k_sc, k_rot = jax.random.split(k_geo, 5)
    return dict(
        do_flip=jax.random.bernoulli(k_flip, cfg.hflip_prob),
        do_affine=jax.random.bernoulli(k_p_aff, cfg.affine_prob),
        translate=jax.random.uniform(k_tr, (2,), minval=-cfg.translate_percent,
                                     maxval=cfg.translate_percent),
        scale=jax.random.uniform(k_sc, minval=cfg.scale_range[0], maxval=cfg.scale_range[1]),
        angle_deg=jax.random.uniform(k_rot, minval=-cfg.rotate_limit_deg,
                                     maxval=cfg.rotate_limit_deg),
    )


def _jax_displacement_draws(k_disp, h, w, cfg):
    k_pe, k_ey, k_ex, k_pg, k_gy, k_gx = jax.random.split(k_disp, 6)
    lim, steps = cfg.grid_distort_limit, cfg.grid_num_steps
    return dict(
        do_elastic=jax.random.bernoulli(k_pe, cfg.elastic_prob),
        noise_y=jax.random.uniform(k_ey, (h, w, 1), minval=-1.0, maxval=1.0)[..., 0],
        noise_x=jax.random.uniform(k_ex, (h, w, 1), minval=-1.0, maxval=1.0)[..., 0],
        do_grid=jax.random.bernoulli(k_pg, cfg.grid_distort_prob),
        grid_y=jax.random.uniform(k_gy, (steps,), minval=-lim, maxval=lim),
        grid_x=jax.random.uniform(k_gx, (steps,), minval=-lim, maxval=lim),
    )


def _jax_color_draws(k_color, h, w, cfg):
    (k_pj, k_b, k_c, k_s, k_h, k_pbc, k_b2, k_c2, k_pnb, k_which,
     k_std, k_noise, k_sig) = jax.random.split(k_color, 13)
    u = jax.random.uniform
    return dict(
        do_jitter=jax.random.bernoulli(k_pj, cfg.color_jitter_prob),
        brightness=u(k_b, minval=-cfg.brightness, maxval=cfg.brightness),
        contrast=u(k_c, minval=-cfg.contrast, maxval=cfg.contrast),
        saturation=u(k_s, minval=-cfg.saturation, maxval=cfg.saturation),
        hue=u(k_h, minval=-cfg.hue, maxval=cfg.hue),
        do_bc=jax.random.bernoulli(k_pbc, cfg.brightness_contrast_prob),
        bc_brightness=u(k_b2, minval=-cfg.brightness, maxval=cfg.brightness),
        bc_contrast=u(k_c2, minval=-cfg.contrast, maxval=cfg.contrast),
        do_noise_blur=jax.random.bernoulli(k_pnb, cfg.noise_blur_prob),
        pick_noise=jax.random.bernoulli(k_which, 0.5),
        noise_std=u(k_std, minval=cfg.noise_std_range[0], maxval=cfg.noise_std_range[1]),
        noise=jax.random.normal(k_noise, (h, w, 3)),
        blur_sigma=u(k_sig, minval=cfg.blur_sigma_range[0], maxval=cfg.blur_sigma_range[1]),
    )


def _to_port(cls, d):
    return cls(**{k: t(v) for k, v in d.items()})


def augment_draws_from_key(key, b, h, w, cfg, keypoints=False):
    """``augment_batch``'s draws: split(key, B), then per sample
    split(k, 3) -> geometry, displacement, colour."""

    def one(k):
        k_geo, k_disp, k_color = jax.random.split(k, 3)
        return (_jax_geometry_draws(k_geo, cfg),
                None if keypoints else _jax_displacement_draws(k_disp, h, w, cfg),
                _jax_color_draws(k_color, h, w, cfg))

    g, dsp, c = jax.jit(jax.vmap(one))(jax.random.split(key, b))
    return A.AugmentDraws(_to_port(A.GeometryDraws, g),
                          None if keypoints else _to_port(A.DisplacementDraws, dsp),
                          _to_port(A.ColorDraws, c))


def _jax_scene_draws(key, h, w, negative_prob, counts, real_prob, keep_in_frame):
    """``_render_scene``'s draws for one key (``counts``: the bank's
    backgrounds, HDRIs, textures, light fields)."""
    (k_bg, k_tex, k_scale, k_rot, k_pos, k_persp, k_light, k_neg, k_exp,
     k_asset, k_real) = jax.random.split(key, 11)
    u = jax.random.uniform
    kb = jax.random.split(k_bg, 6)
    kt = jax.random.split(k_tex, 6)
    lk = jax.random.split(k_light, 5)
    two_pi = 2 * jnp.pi
    d = dict(
        bg_c0=u(kb[0], (3,)), bg_c1=u(kb[1], (3,)), bg_angle=u(kb[2], minval=0.0, maxval=two_pi),
        bg_freq=u(kb[3], (4,), minval=1.0, maxval=8.0),
        bg_noise=u(kb[4], (h, w, 1), minval=-0.04, maxval=0.04)[..., 0],
        border_col=u(kt[0], (3,), minval=0.0, maxval=0.15),
        frame_col=u(kt[1], (3,), minval=0.2, maxval=0.9),
        art_col=u(kt[2], (3,), minval=0.1, maxval=0.9),
        art_col2=u(kt[3], (3,), minval=0.1, maxval=0.9),
        text_col=u(kt[4], (3,), minval=0.7, maxval=0.95),
        tex_f=u(kt[5], (4,), minval=0.0, maxval=1.0),
        scale=u(k_scale, minval=0.35, maxval=0.72 if keep_in_frame else 0.95),
        angle=u(k_rot, minval=0.0, maxval=two_pi),
        pos=jnp.stack([u(k_pos, minval=-0.2, maxval=0.2),
                       u(jax.random.fold_in(k_pos, 1), minval=-0.2, maxval=0.2)]),
        persp=u(k_persp, (4, 2), minval=-0.06, maxval=0.06),
        has_card=jnp.logical_not(jax.random.bernoulli(k_neg, negative_prob)),
        light_pos=jnp.stack([u(lk[0], minval=0.0, maxval=1.0), u(lk[1], minval=0.0, maxval=1.0)]),
        exposure=u(k_exp, minval=0.85, maxval=1.15),
    )
    nb, ne, nt, nl = counts
    fold = jax.random.fold_in
    if nb:
        d.update(bg_index=jax.random.randint(fold(k_asset, 0), (), 0, nb),
                 use_real_bg=jax.random.bernoulli(fold(k_real, 0), real_prob))
    if ne:
        d.update(hdri_index=jax.random.randint(fold(k_asset, 2), (), 0, ne),
                 hdri_rot=u(fold(k_asset, 3)),
                 use_hdri_bg=jax.random.bernoulli(fold(k_real, 2),
                                                  real_prob * (0.5 if nb else 1.0)))
    if nt:
        d.update(tex_index=jax.random.randint(fold(k_asset, 1), (), 0, nt),
                 use_real_tex=jax.random.bernoulli(fold(k_real, 1), real_prob))
    if nl:
        d.update(light_index=jax.random.randint(lk[2], (), 0, nl), light_rot=u(lk[3]),
                 light_strength=u(lk[4], minval=0.8, maxval=1.5))
    return d


def _scene_to_port(d):
    out = {}
    for k, v in d.items():
        v = t(v)
        out[k] = v.long() if k.endswith("_index") else v
    return S.SceneDraws(**out)


def _counts(bank):
    if bank is None:
        return (0, 0, 0, 0)
    return (bank.backgrounds.shape[0], bank.hdris.shape[0], bank.textures.shape[0],
            bank.hdri_light.shape[0])


def scene_draws_from_key(key, b, h, w, negative_prob, bank=None, real_prob=0.7,
                         keep_in_frame=False):
    """``synthetic_batch``'s draws: split(key, B), then per sample
    ``_render_scene``'s sequence."""
    fn = jax.jit(jax.vmap(lambda k: _jax_scene_draws(
        k, h, w, negative_prob, _counts(bank), real_prob, keep_in_frame)))
    return _scene_to_port(fn(jax.random.split(key, b)))


def augmented_scene_draws_from_key(key, b, h, w, negative_prob, cfg, with_displacement,
                                   bank=None, real_prob=0.7, keep_in_frame=False):
    """``synthetic_augmented_batch``'s draws: split(key, B), then per
    sample split(k, 4) -> scene, geometry, displacement, colour."""
    jcfg = _jcfg(cfg)

    def one(k):
        k_scene, k_geo, k_disp, k_color = jax.random.split(k, 4)
        return (_jax_scene_draws(k_scene, h, w, negative_prob, _counts(bank), real_prob,
                                 keep_in_frame),
                _jax_geometry_draws(k_geo, jcfg),
                _jax_displacement_draws(k_disp, h, w, jcfg) if with_displacement else None,
                _jax_color_draws(k_color, h, w, jcfg))

    sc, g, dsp, c = jax.jit(jax.vmap(one))(jax.random.split(key, b))
    aug = A.AugmentDraws(_to_port(A.GeometryDraws, g),
                         _to_port(A.DisplacementDraws, dsp) if with_displacement else None,
                         _to_port(A.ColorDraws, c))
    return S.AugmentedSceneDraws(_scene_to_port(sc), aug)


def _banks(seed=3):
    """A seeded asset bank in both packages: 2 textures, 3 backgrounds, 2
    HDRIs and their light fields."""
    r = _rng(seed)
    arrs = [r.random((2, 22, 16, 3)), r.random((3, 30, 40, 3)), r.random((2, 8, 16, 3)),
            0.5 + r.random((2, 16, 32, 3))]
    arrs = [a.astype(np.float32) for a in arrs]
    return (jsyn.AssetBank(*(jnp.asarray(a) for a in arrs)),
            S.AssetBank(*(torch.from_numpy(a) for a in arrs)))


def assert_images(port, ref, tol=IMG_TOL):
    d = np.abs(n(port) - np.asarray(ref))
    assert d.max() <= tol, d.max()


def agreement(port, ref):
    return float((n(port) == np.asarray(ref)).mean())


# --------------------------------------------------------------------------
# warp.py


def _coords(seed, b, h, w):
    """Source coordinates from 3 pixels outside to 2 beyond the far edge."""
    r = _rng(seed)
    y = r.uniform(-3.0, h + 2.0, (b, h, w)).astype(np.float32)
    x = r.uniform(-3.0, w + 2.0, (b, h, w)).astype(np.float32)
    # exact halves and integers, where round and the validity windows decide
    y[:, 0, :8] = np.array([-0.5, 0.5, 1.5, 2.5, h - 0.5, h - 1.0, 0.0, -0.49])
    x[:, 1, :8] = np.array([-0.5, 0.5, 1.5, 2.5, w - 0.5, w - 1.0, 0.0, -0.51])
    return y, x


def test_warp_bilinear_and_nearest_match_jax():
    b, hs, ws = 3, 20, 16
    r = _rng(0)
    img = r.random((b, hs, ws, 3)).astype(np.float32)
    mask = r.integers(0, 5, (b, hs, ws)).astype(np.int32)
    y, x = _coords(1, b, H, W_)
    y, x = y * (hs / H), x * (ws / W_)
    y[:, 0, :8] = np.array([-0.5, 0.5, 1.5, 2.5, hs - 0.5, hs - 1.0, 0.0, -0.49])
    ref_b = jax.jit(jax.vmap(jwarp.warp_bilinear))(img, y, x)
    ref_n = jax.jit(jax.vmap(jwarp.warp_nearest))(mask, y, x)
    assert_images(W.warp_bilinear(t(img), t(y), t(x)), ref_b, 1e-5)
    assert np.array_equal(n(W.warp_nearest(t(mask), t(y), t(x))), np.asarray(ref_n))
    # a bank sampled per sample by index, without copying images
    idx = np.array([2, 0, 2])
    assert_images(W.warp_bilinear(t(img), t(y), t(x), torch.tensor(idx)),
                  jax.jit(jax.vmap(jwarp.warp_bilinear))(img[idx], y, x), 1e-5)


def test_warp_geometry_functions_match_jax():
    b = 4
    r = _rng(2)
    tr = r.uniform(-10, 10, (b, 2)).astype(np.float32)
    sc = r.uniform(0.8, 2.0, b).astype(np.float32)
    an = r.uniform(-0.5, 0.5, b).astype(np.float32)
    center = ((H - 1) / 2.0, (W_ - 1) / 2.0)
    jm = jax.vmap(lambda a, s, g: jwarp.affine_matrix(a, s, g, center))(tr, sc, an)
    m = W.affine_matrix(t(tr), t(sc), t(an), center)
    np.testing.assert_allclose(n(m), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(W.invert_affine(m)), np.asarray(jax.vmap(jwarp.invert_affine)(jm)),
                               rtol=1e-5, atol=1e-5)
    # a homography with perspective terms
    hm = np.asarray(jm).copy()
    hm[:, 2, :2] = r.uniform(-2e-3, 2e-3, (b, 2))
    sy, sx = W.apply_homography_grid(t(hm), H, W_)
    jy, jx = jax.vmap(lambda mm: jwarp.apply_homography_grid(mm, H, W_))(hm)
    np.testing.assert_allclose(n(sy), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(sx), np.asarray(jx), rtol=1e-5, atol=1e-5)
    pts = r.uniform(-5, 60, (b, 4, 2)).astype(np.float32)
    np.testing.assert_allclose(n(W.transform_points(t(hm), t(pts))),
                               np.asarray(jax.vmap(jwarp.transform_points)(hm, pts)),
                               rtol=1e-5, atol=1e-5)
    ident_y, ident_x = W.identity_grid(H, W_)
    jy, jx = jwarp.identity_grid(H, W_)
    assert np.array_equal(n(ident_y), np.asarray(jy)) and np.array_equal(n(ident_x), np.asarray(jx))


def test_homography_from_points_matches_jax():
    r = _rng(4)
    b = 4
    src = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    dst = (src * [30, 40] + r.uniform(-3, 3, (b, 4, 2)) + [8, 10]).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jwarp.homography_from_points))(dst, np.broadcast_to(src, (b, 4, 2))))
    got = n(W.homography_from_points(t(dst), t(np.broadcast_to(src, (b, 4, 2)).copy())))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= 1e-4, rel
    # it maps the points it was given
    back = n(W.transform_points(torch.from_numpy(got), t(dst)))
    np.testing.assert_allclose(back, np.broadcast_to(src, (b, 4, 2)), atol=1e-4)


@pytest.mark.parametrize("radius", [3, 5, 15])
def test_gaussian_blur_matches_jax(radius):
    r = _rng(5 + radius)
    b, c = 3, 3 if radius != 15 else 1
    img = r.random((b, 24, 20, c)).astype(np.float32)
    sigma = r.uniform(0.5, 5.0, b).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda i, s: jwarp.gaussian_blur(i, s, radius)))(img, sigma)
    assert_images(W.gaussian_blur(t(img), t(sigma), radius), ref, 1e-5)
    np.testing.assert_allclose(
        n(W.gaussian_kernel_1d(t(sigma), radius)),
        np.asarray(jax.vmap(lambda s: jwarp.gaussian_kernel_1d(s, radius))(sigma)),
        atol=1e-6)


# --------------------------------------------------------------------------
# augment.py

ALL_ON = dict(hflip_prob=1.0, affine_prob=1.0, elastic_prob=1.0, grid_distort_prob=1.0,
              color_jitter_prob=1.0, brightness_contrast_prob=1.0, noise_blur_prob=1.0)
ALL_OFF = {k: 0.0 for k in ALL_ON}
CASES = {"default": {}, "on": ALL_ON, "off": ALL_OFF}


@pytest.mark.parametrize("case", sorted(CASES))
def test_geometry_matrix_matches_jax(case):
    cfg = AugmentConfig(**CASES[case])
    key = jax.random.key(11)
    d = augment_draws_from_key(key, 4, H, W_, _jcfg(cfg))
    m, flip = A.geometry_matrix(d.geometry, H, W_)
    jm, jflip = jax.vmap(lambda k: jaug._geometry_matrix(jax.random.split(k, 3)[0], H, W_,
                                                         _jcfg(cfg)))(jax.random.split(key, 4))
    np.testing.assert_allclose(n(m), np.asarray(jm), rtol=1e-5, atol=1e-4)
    assert np.array_equal(n(flip), np.asarray(jflip))


@pytest.mark.parametrize("elastic,grid", [(0.0, 1.0), (1.0, 0.0), (1.0, 1.0)])
def test_displacement_fields_match_jax(elastic, grid):
    cfg = AugmentConfig(elastic_prob=elastic, grid_distort_prob=grid)
    key = jax.random.key(12)
    d = augment_draws_from_key(key, 3, H, W_, _jcfg(cfg))
    dy, dx = A.displacement_fields(d.displacement, H, W_, cfg)
    jdy, jdx = jax.jit(jax.vmap(lambda k: jaug._displacement_fields(
        jax.random.split(k, 3)[1], H, W_, _jcfg(cfg))))(jax.random.split(key, 3))
    # offsets in pixels; the grid's nodes are np.linspace in float32, one ulp
    # of 64 from jnp.linspace's at most
    np.testing.assert_allclose(n(dy), np.asarray(jdy), atol=2e-5)
    np.testing.assert_allclose(n(dx), np.asarray(jdx), atol=2e-5)
    assert float(dy.abs().max()) > 0.1


@pytest.mark.parametrize("case", sorted(CASES))
def test_color_ops_match_jax(case):
    cfg = AugmentConfig(**CASES[case])
    key = jax.random.key(13)
    b = 4
    img = _rng(6).random((b, H, W_, 3)).astype(np.float32)
    d = augment_draws_from_key(key, b, H, W_, _jcfg(cfg))
    ref = jax.jit(jax.vmap(lambda k, x: jaug._color_ops(jax.random.split(k, 3)[2], x,
                                                        _jcfg(cfg))))(jax.random.split(key, b), img)
    assert_images(A.color_ops(d.color, t(img)), ref)
    if case == "on":  # both branches of the OneOf are taken in this batch
        assert 0 < int(d.color.pick_noise.sum()) < b


@pytest.mark.parametrize("keypoints", [False, True])
def test_augment_batch_matches_jax(keypoints):
    cfg = AugmentConfig()
    key = jax.random.key(17)  # samples 1 and 3 are flipped
    b = 4
    r = _rng(7)
    imgs = r.random((b, H, W_, 3)).astype(np.float32)
    kpts = (np.array([[10, 12], [38, 9], [40, 52], [7, 50]]) + r.uniform(-3, 3, (b, 4, 2))
            ).astype(np.float32)
    yy, xx = np.mgrid[:H, :W_]
    masks = ((yy[None] > kpts[:, :1, 1:2]) & (xx[None] > kpts[:, :1, 0:1])
             & (yy[None] < 50) & (xx[None] < 38)).astype(np.int32)
    d = augment_draws_from_key(key, b, H, W_, _jcfg(cfg), keypoints)
    flip_idx = (1, 0, 3, 2)
    if keypoints:
        ref = jax.jit(lambda k, i, m, p: jaug.augment_batch(k, i, m, _jcfg(cfg), p, flip_idx))(
            key, imgs, masks, kpts)
        out = A.augment_batch(d, t(imgs), t(masks), cfg, t(kpts), flip_idx)
        np.testing.assert_allclose(n(out.keypoints), np.asarray(ref.keypoints), atol=1e-3)
        assert 0 < int(d.geometry.do_flip.sum()) < b
    else:
        ref = jax.jit(lambda k, i, m: jaug.augment_batch(k, i, m, _jcfg(cfg)))(key, imgs, masks)
        out = A.augment_batch(d, t(imgs), t(masks), cfg)
        assert out.keypoints is None
    assert_images(out.image, ref.image)
    # the warped grid's round decides the nearest warp: float path
    assert agreement(out.mask, ref.mask) >= MASK_AGREE
    assert out.mask.dtype == torch.int32


# --------------------------------------------------------------------------
# synthetic.py


@pytest.mark.parametrize("bank", [False, True])
def test_render_scene_matches_jax(bank):
    jbank, pbank = _banks() if bank else (None, None)
    key, b = jax.random.key(21), 4
    ref = jsyn.synthetic_batch(key, b, H, W_, 0.3, jbank, 0.7)
    d = scene_draws_from_key(key, b, H, W_, 0.3, jbank)
    out = S.render_scene(d, H, W_, assets=pbank)
    assert_images(out.image, ref.image)
    assert agreement(out.mask, ref.mask) >= MASK_AGREE  # alpha > 0.5: float path
    np.testing.assert_allclose(n(out.corners), np.asarray(ref.corners), atol=1e-3)
    assert np.array_equal(n(out.has_card), np.asarray(ref.has_card))
    assert out.mask.dtype == torch.int32 and int(out.mask.sum()) > 0
    if bank:  # every kind of asset was used by some sample
        assert all(bool(x.any()) for x in (d.use_real_bg, d.use_real_tex))


@pytest.mark.parametrize("keep_in_frame,with_displacement,bank",
                         [(False, True, False), (True, False, True)])
def test_synthetic_augmented_batch_matches_jax(keep_in_frame, with_displacement, bank):
    cfg = AugmentConfig()
    jbank, pbank = _banks(4) if bank else (None, None)
    key, b = jax.random.key(31), 4
    neg = 0.0 if keep_in_frame else 0.3
    ref = jax.jit(lambda k, assets: jsyn.synthetic_augmented_batch(
        k, b, H, W_, neg, _jcfg(cfg), with_displacement, (1, 0, 3, 2), assets, 0.7,
        keep_in_frame))(key, jbank)
    d = augmented_scene_draws_from_key(key, b, H, W_, neg, cfg, with_displacement, jbank,
                                       keep_in_frame=keep_in_frame)
    out = S.render_augmented_scene(d, H, W_, cfg, pbank, keep_in_frame)
    assert_images(out.image, ref.image)
    assert agreement(out.mask, ref.mask) >= MASK_AGREE
    np.testing.assert_allclose(n(out.corners), np.asarray(ref.corners), atol=1e-3)
    if keep_in_frame:  # the base quad lies in the frame before augmentation
        base = S.render_scene(d.scene, H, W_, keep_in_frame=True).corners
        assert float(base.min()) >= 2.0 - 1e-4
        assert float(base[..., 0].max()) <= W_ - 3.0 + 1e-4
        assert float(base[..., 1].max()) <= H - 3.0 + 1e-4


def test_canonicalize_corners_matches_jax():
    r = _rng(8)
    quad = np.array([[10, 10], [40, 12], [38, 50], [8, 46]], np.float32)
    cases = [quad]
    for ang in (0.3, 1.7, 3.0, -2.2):  # turned past 90 degrees too
        c, s = math.cos(ang), math.sin(ang)
        cases.append(((quad - 25) @ np.array([[c, -s], [s, c]], np.float32).T + 25))
    cases.append(quad[:, ::-1].copy())  # flipped winding
    cases.append(quad * [-1, 1] + [48, 0])  # mirrored
    cases.append(np.full((4, 2), -1, np.float32))  # degenerate: no card
    cases.append(np.array([[5, 5], [5, 5], [20, 5], [20, 30]], np.float32))  # repeated point
    cases.append(r.uniform(0, 60, (4, 2)).astype(np.float32))
    c = np.stack(cases).astype(np.float32)
    ref = jax.vmap(jsyn.canonicalize_corners)(c)
    assert np.array_equal(n(S.canonicalize_corners(t(c))), np.asarray(ref))


def test_sdf_band_texture_and_background_match_jax():
    r = _rng(9)
    key = jax.random.key(41)
    u = r.uniform(-0.2, 1.2, (2, H, W_)).astype(np.float32)
    v = r.uniform(-0.2, 1.2, (2, H, W_)).astype(np.float32)
    np.testing.assert_allclose(n(S.rounded_rect_sdf(t(u), t(v))),
                               np.asarray(jsyn._rounded_rect_sdf(u, v)), atol=1e-4)
    np.testing.assert_allclose(n(S.band(t(u), 0.1, 0.9)), np.asarray(jsyn._band(u, 0.1, 0.9)),
                               atol=1e-6)
    keys = jax.random.split(key, 2)
    d = scene_draws_from_key(key, 2, H, W_, 0.0)

    ref_tex = jax.jit(jax.vmap(lambda k, uu, vv: jsyn._card_texture(
        jax.random.split(k, 11)[1], uu, vv)))(keys, u, v)
    assert_images(S.card_texture(d, t(u), t(v)), ref_tex)
    y, x = W.identity_grid(H, W_)
    ref_bg = jax.jit(jax.vmap(lambda k: jsyn._background_at(
        jax.random.split(k, 11)[0], *jwarp.identity_grid(H, W_), H, W_)))(keys)
    assert_images(S.background_at(d, y.expand(2, H, W_), x.expand(2, H, W_), H, W_), ref_bg)
