"""The plain references against the port at tiny sizes on the host: the
port run in float32 must agree with its reference to rounding, so that on
the card what separates the two is the port's bf16 and nothing else."""


import numpy as np
import pytest
import torch

import core
import weights

SEG = core.load_json("configs/seg-mnv3l-lraspp.json")
POSE = dict(core.load_json("configs/pose-hrnet-w18s.json"), heatmap_hw=[16, 24])


def trees(cfg, seed):
    return weights.make_trees(cfg, seed, torch.device("cpu"))


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_seg_masks_equal_the_ports_float32_path(seed):
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

    ref = core.load_module("reference/seg-mnv3l-lraspp.py")
    p, s = trees(SEG, seed)
    x = torch.randint(0, 256, (3, 64, 96, 3), generator=torch.Generator().manual_seed(seed),
                      dtype=torch.uint8)
    ref.calibrate(SEG, p, s, x[:2])
    for use_kernels in (True, False):
        pred = SegPredictor(p, s, 64, 96, use_kernels=use_kernels, dtype=torch.float32,
                            device="cpu")
        got = ref.judge(SEG, p, s, x.numpy(), pred.predict(x).numpy(), "cpu")
        assert got["mask_mismatch"] <= 2e-4 and got["mask_gap"] < 0.01


def test_seg_calibration_splits_the_classes():
    ref = core.load_module("reference/seg-mnv3l-lraspp.py")
    p, s = trees(SEG, 7)
    x = torch.randint(0, 256, (2, 64, 64, 3), generator=torch.Generator().manual_seed(7),
                      dtype=torch.uint8)
    ref.calibrate(SEG, p, s, x)
    share = float(ref.masks(SEG, ref.tensors(p, "cpu"), ref.tensors(s, "cpu"), x).float().mean())
    assert 0.4 < share < 0.6


def test_pose_heatmaps_and_decode_equal_the_ports_float32_path():
    from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor

    ref = core.load_module("reference/pose-hrnet-w18s.py")
    p, s = trees(POSE, 3)
    x = torch.randint(0, 256, (4, 64, 96, 3), generator=torch.Generator().manual_seed(3),
                      dtype=torch.uint8)
    pred = PosePredictor(p, s, 64, 96, heatmap_hw=(16, 24), dtype=torch.float32, device="cpu")
    hm = pred.heatmaps(x)
    px, conf = pred.decode(hm)
    out = {"heatmaps": hm.numpy(), "corners": px.numpy(), "conf": conf.numpy()}
    got = ref.judge(POSE, p, s, x.numpy(), out, "cpu")
    assert got["heatmap_err"] < 1e-5
    assert got["corner_px"] < 1e-3 and got["conf_err"] == 0.0


def test_pose_decode_takes_every_branch():
    """Random heatmaps: plausible quads keep the independent decode, the
    others go through the joint decode; one dead channel is completed."""
    from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm_lib

    ref = core.load_module("reference/pose-hrnet-w18s.py")
    rng = np.random.default_rng(0)
    hm = rng.standard_normal((64, 16, 24, 4)).astype(np.float32)
    # a plausible quad of peaks in half of them, a dead channel in some
    for b in range(0, 64, 2):
        for k, (y, x) in enumerate([(3, 4), (3, 19), (12, 19), (12, 4)]):
            hm[b, y, x, k] = 6.0 + rng.random()
    hm[1::4, :, :, 2] -= 8.0
    hm[1::4, 5, 5, 0] = hm[1::4, 5, 12, 1] = hm[1::4, 11, 5, 3] = 9.0
    want_c, want_v = hm_lib.decode_argmax_subpixel_gated(torch.from_numpy(hm))
    px, conf = ref.decode(POSE, hm, (64, 96))
    np.testing.assert_allclose(px, (want_c * torch.tensor([95.0, 63.0])).numpy(), atol=1e-4)
    np.testing.assert_array_equal(conf, want_v.numpy())
