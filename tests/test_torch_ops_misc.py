"""The port's ``ops/misc.py`` against the JAX package's, on the CPU.

Every op goes through both packages' registered forwards on the same
seeded numpy inputs (``check_op``).  Copies, slices, indexing, counts
and integer results are bitwise equal; f32 arithmetic within rtol 1e-5
/ atol 1e-6 (1e-5 where a transcendental or a reordered sum enters:
LRN, the resize, the sampler family); gradients against ``jax.vjp`` of
the JAX op within rtol 1e-4 / atol 1e-5, including the loss layers
whose gradient ignores the incoming one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.ndarray  # noqa: F401  (registers every JAX op)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from test_torch_ops_tensor import EXACT, check_op

F32 = dict(rtol=1e-5, atol=1e-5)


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


# -- elementwise, reductions, small helpers ---------------------------------------------


@pytest.mark.parametrize("name", ["add_n", "ElementWiseSum", "_sum"])
def test_add_n_and_aliases_match_jax(name):
    xs = [_f32(3, 4, seed=s) for s in range(3)]
    check_op(name, xs, {"num_args": 3}, diff=(0, 1, 2), fwd=EXACT)


def test_elementwise_helpers_match_jax():
    x, y = _f32(4, 5), _f32(4, 5, seed=1)
    check_op("hard_sigmoid", [x * 4], {"alpha": 0.3, "beta": 0.4}, diff=(0,))
    check_op("_grad_add", [x, y], diff=(0, 1), fwd=EXACT)
    check_op("_hypot_scalar", [x], {"scalar": 1.5}, diff=(0,))
    check_op("_identity_with_attr_like_rhs", [x, y], diff=(0,), fwd=EXACT)
    check_op("_scatter_plus_scalar", [x], {"scalar": 0.25}, fwd=EXACT)
    check_op("_scatter_minus_scalar", [x], {"scalar": 2.0}, fwd=EXACT)
    check_op("_scatter_elemwise_div", [x, y], diff=(0, 1))
    ints = np.arange(12, dtype=np.int32).reshape(3, 4)
    check_op("_scatter_plus_scalar", [ints], {"scalar": 3}, fwd=EXACT)
    check_op("cast_storage", [x], {"stype": "row_sparse"}, fwd=EXACT)


@pytest.mark.parametrize("kw", [{}, {"axes": (0, 2), "keepdims": True},
                                {"axes": (1,)}])
def test_moments_and_square_sum_match_jax(kw):
    x = _f32(3, 4, 5)
    check_op("moments", [x], kw, diff=(0,))
    check_op("_square_sum", [x], {"axis": kw.get("axes"),
                                  "keepdims": kw.get("keepdims", False)},
             diff=(0,))


def test_zeros_without_dtype_and_rnn_param_concat_match_jax():
    got = treg.get("_zeros_without_dtype").forward(shape=(2, 3),
                                                   device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2, 3) \
        and not got.any()
    with tmx.cpu():
        z = tmx.nd._zeros_without_dtype(shape=(4,))
    assert z.shape == (4,) and z.asnumpy().sum() == 0
    check_op("_rnn_param_concat", [_f32(2, 3), _f32(4, seed=1)],
             {"num_args": 2}, fwd=EXACT)
    check_op("_rnn_param_concat", [_f32(2, 3), _f32(1, 3, seed=1)],
             {"num_args": 2, "dim": 0}, fwd=EXACT)


def test_batch_take_and_index_ravels_match_jax():
    a = _f32(4, 5)
    check_op("batch_take", [a, np.array([0, 4, 2, 1], np.float32)],
             diff=(0,), fwd=EXACT)
    flat = np.array([[0, 7, 23], [11, 5, 19]], np.float32)
    check_op("_unravel_index", [flat], {"shape": (2, 3, 4)}, fwd=EXACT)
    coords = np.array([[0, 1, 2, 5], [2, 0, 1, -1], [3, 3, 0, 1]],
                      np.float32)
    check_op("_ravel_multi_index", [coords], {"shape": (2, 3, 4)}, fwd=EXACT)


@pytest.mark.parametrize("kw", [{"bin_cnt": 7, "range": (-2.0, 2.0)},
                                {"bin_cnt": 4}])
def test_histogram_matches_jax(kw):
    """The counts bitwise; the edges (``jnp.linspace``, which XLA rounds
    its own way) within f32 ulps."""
    x = _f32(50) * 1.5
    check_op("_histogram", [x], kw, fwd=F32)
    got = treg.get("_histogram").forward(torch.from_numpy(x), **kw)
    want = jreg.get("_histogram").forward(x, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_histogram_with_edges_matches_jax():
    x = _f32(40)
    edges = np.array([-3.0, -1.0, 0.0, 0.5, 2.0], np.float32)
    got = treg.get("_histogram").forward(torch.from_numpy(x), bins=edges)
    want = jreg.get("_histogram").forward(x, bins=edges)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sparse_retain_matches_jax():
    x = _f32(6, 3)
    check_op("_sparse_retain", [x, np.array([4, 0, -1], np.float32)],
             diff=(0,), fwd=EXACT)


@pytest.mark.parametrize("sl", [((1, 0), (4, 3), ()),
                                ((None, 1), (None, None), (2, 2)),
                                ((5, None), (0, None), (-2, None))])
def test_slice_assign_matches_jax(sl):
    begin, end, step = sl
    x = _f32(6, 4)
    want = jreg.get("_slice_assign_scalar").forward(
        jnp.asarray(x), scalar=7.0, begin=begin, end=end, step=step)
    rhs = np.asarray(want)[tuple(
        slice(b, e, s) for b, e, s in zip(begin, end,
                                           step or (None,) * 2))]
    rhs = _f32(*rhs.shape, seed=3)
    check_op("_slice_assign", [x, rhs],
             {"begin": begin, "end": end, "step": step}, diff=(0, 1),
             fwd=EXACT)
    check_op("_slice_assign_scalar", [x],
             {"scalar": 7.0, "begin": begin, "end": end, "step": step},
             fwd=EXACT)


def test_aliases_point_at_the_modern_ops():
    for new, old in (("BatchNorm_v1", "BatchNorm"),
                     ("Convolution_v1", "Convolution"),
                     ("Pooling_v1", "Pooling"), ("CuDNNBatchNorm", "BatchNorm"),
                     ("_CrossDeviceCopy", "identity"),
                     ("_split_v2", "split_v2"),
                     ("MakeLoss_grad_stop", "stop_gradient")):
        assert treg.get(new) is treg.get(old), new
    check_op("_CrossDeviceCopy", [_f32(3)], fwd=EXACT)


# -- the loss layers, straight-through estimators -----------------------------------------


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput",
                                  "linearregression_output"])
def test_regression_outputs_match_jax(name):
    x, lab = _f32(4, 3), _f32(4, 3, seed=1)
    check_op(name, [x, lab], {"grad_scale": 0.5}, diff=(0,))
    check_op(name, [x, lab.reshape(12)[:4].copy()[:, None].repeat(3, 1)],
             diff=(0,))


@pytest.mark.parametrize("linear", [False, True])
def test_svm_output_matches_jax(linear):
    x = _f32(5, 4)
    lab = np.array([0, 3, 1, 1, 2], np.float32)
    check_op("SVMOutput", [x, lab],
             {"margin": 0.8, "regularization_coefficient": 1.5,
              "use_linear": linear}, diff=(0,), fwd=EXACT)


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_make_loss_matches_jax(norm):
    check_op("MakeLoss", [_f32(4, 3)],
             {"grad_scale": 2.0, "normalization": norm, "valid_thresh": 0.1},
             diff=(0,), fwd=EXACT)


def test_identity_attach_kl_sparse_reg_matches_jax():
    x = np.random.RandomState(0).uniform(0.05, 0.95, (6, 4)) \
        .astype(np.float32)
    check_op("IdentityAttachKLSparseReg", [x],
             {"sparseness_target": 0.2, "penalty": 0.01}, diff=(0,),
             fwd=EXACT)


def test_straight_through_quadratic_and_allclose_match_jax():
    x = _f32(3, 5) * 3
    check_op("_contrib_round_ste", [x], diff=(0,), fwd=EXACT)
    check_op("_contrib_sign_ste", [x], diff=(0,), fwd=EXACT)
    check_op("_contrib_quadratic", [x], {"a": 0.5, "b": -1.0, "c": 2.0},
             diff=(0,))
    check_op("_contrib_backward_quadratic", [x], {"a": 1.5}, diff=(0,))
    y = x + 1e-6
    check_op("_contrib_allclose", [x, y], fwd=EXACT)
    check_op("_contrib_allclose", [x, x + 1], {"atol": 0.5}, fwd=EXACT)


# -- im2col, col2im, LRN, Crop --------------------------------------------------------


@pytest.mark.parametrize("geo", [
    dict(kernel=(3, 3), stride=(1, 1), dilate=(1, 1), pad=(1, 1)),
    dict(kernel=(2, 3), stride=(2, 1), dilate=(1, 2), pad=(0, 1)),
    dict(kernel=(3,), stride=(2,), pad=(1,)),
    dict(kernel=(2, 2, 2), stride=(1, 2, 1))])
def test_im2col_and_col2im_match_jax(geo):
    nd = len(geo["kernel"])
    spatial = (6, 7, 5)[:nd]
    x = _f32(2, 3, *spatial)
    check_op("im2col", [x], geo, diff=(0,), fwd=EXACT)
    cols = np.asarray(jreg.get("im2col").forward(x, **geo))
    check_op("col2im", [cols], dict(geo, output_size=spatial), diff=(0,),
             fwd=F32)


def test_lrn_and_crop_match_jax():
    x = _f32(2, 7, 4, 5)
    check_op("LRN", [x], {"alpha": 0.01, "beta": 0.6, "knorm": 1.5,
                          "nsize": 3}, diff=(0,), fwd=F32)
    check_op("lrn", [x], diff=(0,), fwd=F32)
    like = np.zeros((2, 7, 2, 3), np.float32)
    check_op("Crop", [x, like], {"num_args": 2, "offset": (1, 2)},
             diff=(0,), fwd=EXACT)
    check_op("crop_legacy", [x], {"h_w": (3, 3), "center_crop": True},
             fwd=EXACT)


# -- image ops ---------------------------------------------------------------------------


def test_image_ops_match_jax():
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    batch = rs.randint(0, 256, (2, 6, 5, 3)).astype(np.uint8)
    check_op("_image_to_tensor", [img], fwd=EXACT)
    check_op("_image_to_tensor", [batch], fwd=EXACT)
    t = rs.uniform(0, 1, (3, 6, 5)).astype(np.float32)
    check_op("_image_normalize", [t], {"mean": (0.4, 0.5, 0.6),
                                       "std": (0.2, 0.25, 0.3)})
    check_op("_image_normalize", [t[None]], {"mean": (0.5,), "std": (0.2,)})
    check_op("_image_crop", [img], {"x": 1, "y": 2, "width": 3, "height": 2},
             fwd=EXACT)
    check_op("_image_crop", [batch], {"x": 0, "y": 1, "width": 4,
                                      "height": 5}, fwd=EXACT)
    check_op("_image_adjust_lighting", [img.astype(np.float32)],
             {"alpha": (0.1, -0.2, 0.05)}, fwd=F32)
    check_op("_image_adjust_lighting", [img], {"alpha": (2.0, -1.0, 3.0)},
             fwd=EXACT)


@pytest.mark.parametrize("kw", [{"size": (8, 9)}, {"size": (4, 3)},
                                {"size": (10, 12), "interp": 0}])
def test_image_resize_matches_jax(kw):
    img = np.random.RandomState(3).uniform(0, 255, (6, 5, 3)) \
        .astype(np.float32)
    check_op("_image_resize", [img], kw, fwd=dict(rtol=1e-4, atol=1e-3))


def test_image_random_lighting_draws_about_its_std():
    img = np.full((4, 4, 3), 100.0, np.float32)
    with tmx.cpu():
        tmx.random.seed(3)
        outs = [tmx.nd._image_random_lighting(tmx.nd.array(img),
                                              alpha_std=0.05).asnumpy()
                for _ in range(400)]
    shift = np.stack([o[0, 0] for o in outs]) - 100.0
    eig = np.array([[55.46 * -0.5675, 4.794 * 0.7192, 1.148 * 0.4009],
                    [55.46 * -0.5808, 4.794 * -0.0045, 1.148 * -0.8140],
                    [55.46 * -0.5836, 4.794 * -0.6948, 1.148 * 0.4203]])
    want = 0.05 * np.sqrt((eig ** 2).sum(1))       # each channel's std
    # 400 draws: the std within 20%, the mean within 5 standard errors
    assert np.all(np.abs(shift.std(0) / want - 1) < 0.2), shift.std(0)
    assert np.all(np.abs(shift.mean(0)) < 5 * want / 20), shift.mean(0)


# -- the spatial transformer family, adaptive pooling, correlation ----------------------


@pytest.mark.parametrize("warp", [False, True])
def test_grid_generator_matches_jax(warp):
    if warp:
        flow = _f32(2, 2, 4, 5)
        check_op("GridGenerator", [flow], {"transform_type": "warp"},
                 diff=(0,), fwd=F32)
    else:
        theta = _f32(2, 6) * 0.5
        check_op("GridGenerator", [theta], {"target_shape": (4, 6)},
                 diff=(0,), fwd=F32)


def test_spatial_transformer_and_bilinear_resize_match_jax():
    x = _f32(2, 3, 6, 7)
    loc = (np.array([[1, 0, 0, 0, 1, 0]] * 2)
           + _f32(2, 6) * 0.2).astype(np.float32)
    check_op("SpatialTransformer", [x, loc], {"target_shape": (5, 4)},
             diff=(0, 1), fwd=F32, grad=dict(rtol=1e-4, atol=1e-4))
    check_op("_contrib_BilinearResize2D", [x], {"height": 9, "width": 5},
             diff=(0,), fwd=F32)
    check_op("_contrib_BilinearResize2D", [x],
             {"scale_height": 1.5, "scale_width": 0.5}, fwd=F32)


@pytest.mark.parametrize("out", [(1, 1), (3, 2), 4])
def test_adaptive_avg_pooling_matches_jax(out):
    check_op("_contrib_AdaptiveAvgPooling2D", [_f32(2, 3, 7, 9)],
             {"output_size": out}, diff=(0,), fwd=F32)


@pytest.mark.parametrize("kw", [{}, {"kernel_size": 3, "max_displacement": 2,
                                     "stride2": 2, "pad_size": 2},
                                {"is_multiply": False, "stride1": 2,
                                 "pad_size": 1}])
def test_correlation_matches_jax(kw):
    a, b = _f32(2, 3, 8, 9), _f32(2, 3, 8, 9, seed=1)
    check_op("Correlation", [a, b], kw, diff=(0, 1), fwd=F32)


def test_sharding_constraint_is_the_identity_on_one_device():
    x = _f32(3, 4)
    check_op("_sharding_constraint", [x], diff=(0,), fwd=EXACT)
    with pytest.raises(MXNetError, match="S8"):
        treg.get("_sharding_constraint").forward(torch.zeros(2),
                                                 sharding="data")
