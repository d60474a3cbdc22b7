"""The port's segmentation model, weight bridge and serving pieces against
the JAX package, fp32 on the CPU, on the same numpy weights and inputs.

fp32 JAX (XLA:CPU) and fp32 PyTorch differ here only in summation order,
so the bar is 1e-4, the JAX package's own for its fp32 model tests
(tests/test_model_seg.py:81, tests/test_serving.py:34).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.export import fold_batch_norm as jax_fold
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.models.layers import ConvBNAct as JaxConvBNAct
from mtg_card_image_segmentation_tpu.models.mobilenetv3 import (
    expected_backbone_params as jax_expected_backbone_params,
)
from mtg_card_image_segmentation_tpu.serving import predictor as jax_pred

from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.models.layers import (
    ConvBNAct,
    hard_sigmoid,
    hard_swish,
)
from mtg_card_image_segmentation_tpu_torch.models.mobilenetv3 import (
    expected_backbone_params,
)
from mtg_card_image_segmentation_tpu_torch.models.registry import create_model
from mtg_card_image_segmentation_tpu_torch.serving import predictor as port_pred
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    count_parameters,
    flax_to_state_dict,
    from_flax,
    init_flax_like,
    state_dict_to_flax,
)

torch.set_num_threads(2)

H, W = 64, 48


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def jax_layout():
    """The JAX model and the shapes of its init variables (no compile)."""
    model = jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    variables = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, H, W, 3)), train=False),
        jax.random.key(0),
    )
    return model, variables["params"], variables["batch_stats"]


@pytest.fixture(scope="module")
def seeded_vars():
    return init_flax_like(0)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_bridge_round_trips_the_flax_tree(seeded_vars):
    """Flax tree -> port modules -> Flax tree, exact."""
    params, stats = seeded_vars
    model = from_flax(params, stats)
    p2, s2 = state_dict_to_flax(model.state_dict())
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, stats)


def test_init_flax_like_has_the_jax_layout(jax_layout, seeded_vars):
    """init_flax_like gives the JAX model's variable tree: same names, same
    shapes, and BN statistics moved off their init values."""
    _, params, stats = jax_layout
    p, s = seeded_vars
    assert jax.tree.structure(p) == jax.tree.structure(params)
    assert jax.tree.structure(s) == jax.tree.structure(stats)
    for x, y in zip(jax.tree.leaves(p), jax.tree.leaves(params)):
        assert np.shape(x) == np.shape(y) and np.asarray(x).dtype == np.float32
    stem = s["backbone"]["stem"]["bn"]
    assert np.abs(stem["mean"]).max() > 0 and np.abs(stem["var"] - 1).max() > 0


def test_param_count_matches_closed_form(jax_layout, seeded_vars):
    """Backbone 2,971,952 (expected_backbone_params) and the full model
    4,201,348 with the head term of tests/test_model_seg.py:46-56."""
    params = jax_layout[1]
    model = from_flax(*seeded_vars)
    head = (960 * 128 * 9 + 2 * 128) + 960 * 128 + (40 * 2 + 2) + (128 * 2 + 2)
    n_backbone = sum(p.numel() for p in model.backbone.parameters())
    n_total = sum(p.numel() for p in model.parameters())
    assert expected_backbone_params() == jax_expected_backbone_params() == 2_971_952
    assert n_backbone == 2_971_952
    assert n_total == expected_backbone_params() + head == 4_201_348
    assert count_parameters(seeded_vars[0]) == 4_201_348
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params)) == 4_201_348
    registry_model = create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    assert sum(p.numel() for p in registry_model.parameters()) == 4_201_348


def test_full_model_matches_jax_fp32(jax_layout, seeded_vars):
    """Port CardSegmentationModel (eval, fp32) vs JAX apply at 64x48, with
    the seeded weights (BN stats off init): 1e-4."""
    jmodel = jax_layout[0]
    p, s = seeded_vars
    x = np.random.default_rng(1).standard_normal((2, H, W, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    want = np.asarray(apply({"params": _jnp_tree(p), "batch_stats": _jnp_tree(s)},
                            jnp.asarray(x)))
    with torch.no_grad():
        got = from_flax(p, s)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, H, W, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_full_model_matches_jax_fp32_320x240(jax_layout, seeded_vars):
    """The same at the config's input size, 320x240, b2: 1e-4."""
    jmodel = jax_layout[0]
    p, s = seeded_vars
    x = np.random.default_rng(7).standard_normal((2, 320, 240, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    want = np.asarray(apply({"params": _jnp_tree(p), "batch_stats": _jnp_tree(s)},
                            jnp.asarray(x)))
    with torch.no_grad():
        got = from_flax(p, s)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 320, 240, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv_padding_matches_torch_and_jax_stride2():
    """Explicit (k-1)//2 padding on a stride-2 conv, the case of
    tests/test_model_seg.py:59: port == F.conv2d == JAX ConvBNAct."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 12, 3)).astype(np.float32)
    w = rng.standard_normal((8, 3, 3, 3)).astype(np.float32)  # OIHW
    block = ConvBNAct(3, 8, 3, stride=2, act=None, use_bn=False, dtype=torch.float32)
    block.conv.weight.data = torch.from_numpy(w)
    with torch.no_grad():
        ours = block(torch.from_numpy(x)).numpy()
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), stride=2, padding=1
    ).permute(0, 2, 3, 1).numpy()
    jblock = JaxConvBNAct(8, 3, stride=2, act=None, use_bn=False, dtype=jnp.float32)
    theirs = np.asarray(jblock.apply(
        {"params": {"conv": {"kernel": jnp.asarray(np.transpose(w, (2, 3, 1, 0)))}}},
        jnp.asarray(x)))
    assert ours.shape == ref.shape == theirs.shape == (1, 8, 6, 8)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


def test_hard_activations_match_torch():
    x = torch.linspace(-6, 6, 101)
    torch.testing.assert_close(hard_swish(x), torch.nn.functional.hardswish(x),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hard_sigmoid(x), torch.nn.functional.hardsigmoid(x),
                               rtol=1e-6, atol=1e-6)


def test_fold_batch_norm_matches_jax(seeded_vars):
    """Port fold (numpy leaves) vs the JAX fold: same tree, float32 values
    within 1e-6 (sqrt/divide rounding only)."""
    p, s = seeded_vars
    ours = fold_batch_norm(p, s)
    theirs = _np_tree(jax.jit(jax_fold)(p, s))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_fold_normalize_into_stem_matches_jax(seeded_vars):
    folded = fold_batch_norm(*seeded_vars)
    ours = port_pred._fold_normalize_into_stem(folded)["backbone"]["stem"]
    theirs = jax_pred._fold_normalize_into_stem(folded)["backbone"]["stem"]
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(ours["conv"][k], np.asarray(theirs["conv"][k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def folded_pair(seeded_vars):
    """Seeded weights folded (BN + normalization into the stem), as the
    port's module (fp32) and as the JAX tree."""
    folded = port_pred._fold_normalize_into_stem(fold_batch_norm(*seeded_vars))
    return from_flax(folded, None, dtype=torch.float32), _jnp_tree(folded)


def test_fused_backbone_taps_match_jax(folded_pair):
    """Port _fused_backbone with every block as its module vs the JAX
    _fused_backbone(fused_ids=()), fp32, 1e-4 relative to the tap's
    largest value (activations reach ~10 after 15 blocks)."""
    model, jtree = folded_pair
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (2, H, W, 3)).astype(np.float32)
    x = u8 - 255.0 * port_pred._IMAGENET_MEAN
    want = jax_pred._fused_backbone(jtree["backbone"], jnp.asarray(x), jnp.float32,
                                    fused_ids=())
    with torch.no_grad():
        got = port_pred._fused_backbone(model.backbone, torch.from_numpy(x))
    for tap in ("low", "high"):
        w = np.asarray(want[tap])
        assert got[tap].shape == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[tap].numpy(), w, rtol=1e-4, atol=1e-4 * scale)


def test_head_score_s8_matches_jax(folded_pair):
    """Port _head_score_s8 vs the JAX one, fp32, on the same taps: 1e-4."""
    model, jtree = folded_pair
    rng = np.random.default_rng(3)
    low = rng.standard_normal((2, 8, 6, 40)).astype(np.float32)
    high = rng.standard_normal((2, 4, 3, 960)).astype(np.float32)
    want = np.asarray(jax_pred._head_score_s8(jtree["head"], jnp.asarray(low),
                                              jnp.asarray(high), jnp.float32))
    with torch.no_grad():
        got = port_pred._head_score_s8(model.head, torch.from_numpy(low),
                                       torch.from_numpy(high)).numpy()
    assert got.shape == want.shape == (2, 8, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_state_dict_names_cover_the_model(seeded_vars):
    """Every parameter and buffer of the port's model has a Flax source."""
    p, s = seeded_vars
    sd = flax_to_state_dict(p, s)
    model = create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    assert set(sd) == set(model.state_dict())
