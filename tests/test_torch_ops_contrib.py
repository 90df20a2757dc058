"""The port's ``ops/contrib.py`` (and O4's plain version) against the JAX
package's ``ops/contrib.py``, on the CPU, and the attention ops as
registered ops.

The same seeded numpy inputs go through both packages' registered
forwards (``check_op``).  Indexing, ordering and keep-or-suppress
results are bitwise equal (ties included); f32 arithmetic within rtol
1e-5 / atol 1e-6; gradients against ``jax.vjp`` of the JAX op within
rtol 1e-4 / atol 1e-5.  O4's plain version is held to the JAX
``_box_nms`` on ties, an all-suppressed set, boxes exactly at the
threshold and random sets, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.ndarray  # noqa: F401  (registers every JAX op)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import box_nms
from mxnet_tpu_torch.ops import registry as treg
from test_torch_ops_tensor import EXACT, check_op

FWD = dict(rtol=1e-5, atol=1e-6)


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def _boxes(rs, n, lo=0.0, hi=1.0):
    """n corner boxes inside [lo, hi]^2."""
    xy = rs.uniform(lo, hi * 0.7, (n, 2))
    wh = rs.uniform(0.05, hi * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# -- FFT, index ops, gradientmultiplier --------------------------------------------


def test_fft_and_ifft_match_jax():
    x = _f32(3, 8)
    check_op("_contrib_fft", [x], fwd=dict(rtol=1e-5, atol=1e-5))
    check_op("_contrib_ifft", [_f32(2, 3, 16, seed=1)],
             fwd=dict(rtol=1e-5, atol=1e-5))


def test_ifft_undoes_fft_times_n():
    x = torch.from_numpy(_f32(2, 8))
    y = treg.get("_contrib_ifft").forward(
        treg.get("_contrib_fft").forward(x))
    np.testing.assert_allclose(y.numpy(), 8 * x.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_index_copy_matches_jax():
    old = _f32(6, 3)
    new = _f32(3, 3, seed=1)
    check_op("_contrib_index_copy",
             [old, np.array([4, 0, -1], np.float32), new], diff=(0, 2),
             fwd=EXACT)


def test_index_array_and_getnnz_match_jax():
    x = _f32(2, 3, 4)
    x[x < 0.3] = 0
    check_op("_contrib_index_array", [x], fwd=EXACT)
    check_op("_contrib_index_array", [x], {"axes": (0, 2)}, fwd=EXACT)
    check_op("_contrib_getnnz", [x], fwd=EXACT)
    check_op("_contrib_getnnz", [x], {"axis": 1}, fwd=EXACT)


def test_gradientmultiplier_scales_the_gradient_as_jax():
    check_op("_contrib_gradientmultiplier", [_f32(4, 3)], {"scalar": -2.5},
             diff=(0,), fwd=EXACT)
    check_op("_contrib_backward_gradientmultiplier", [_f32(4, 3)],
             {"scalar": 0.5}, diff=(0,), fwd=EXACT)


# -- box IoU and NMS ----------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rs = np.random.RandomState(3)
    a, b = _boxes(rs, 5), _boxes(rs, 7)
    check_op("_contrib_box_iou", [a, b], {"format": fmt}, diff=(0, 1))
    check_op("_contrib_box_iou", [a.reshape(1, 5, 4), b.reshape(1, 7, 4)],
             {"format": fmt})


def _dets(rs, b, n, n_cls=3):
    cid = rs.randint(0, n_cls, (b, n, 1)).astype(np.float32)
    score = rs.uniform(0, 1, (b, n, 1)).astype(np.float32)
    return np.concatenate([cid, score,
                           np.stack([_boxes(rs, n) for _ in range(b)])], 2)


@pytest.mark.parametrize("case", ["random", "ties", "center", "valid"])
def test_box_nms_matches_jax_bitwise(case):
    rs = np.random.RandomState(7)
    data = _dets(rs, 2, 40)
    attrs = {"overlap_thresh": 0.3}
    if case == "ties":
        data[:, :, 1] = np.round(data[:, :, 1] * 4) / 4   # many equal scores
        data[0, 5:9] = data[0, 4]                          # identical rows
    if case == "center":
        attrs["in_format"] = "center"
    if case == "valid":
        attrs.update(valid_thresh=0.4, overlap_thresh=0.6, topk=3,
                     id_index=0, force_suppress=False)
    check_op("_contrib_box_nms", [data], attrs, fwd=EXACT)


def test_box_nms_gradient_reaches_kept_rows_as_jax():
    rs = np.random.RandomState(8)
    check_op("_contrib_box_nms", [_dets(rs, 1, 12)], {"overlap_thresh": 0.4},
             diff=(0,), fwd=EXACT)


def _jax_keep(boxes, scores, thresh, valid_thresh=0.0):
    """The JAX package's _box_nms keep mask, read from its output rows."""
    n = boxes.shape[0]
    data = np.concatenate([np.zeros((n, 1), np.float32), scores[:, None],
                           boxes], 1)[None]
    out, _ = jreg.get("_contrib_box_nms").forward(
        jnp.asarray(data), overlap_thresh=thresh, valid_thresh=valid_thresh)
    return ~np.all(np.asarray(out)[0] == -1, axis=1)


def _o4_ref_keep(boxes, scores, thresh, valid_thresh=0.0):
    order = np.argsort(-scores, kind="stable")
    b = torch.from_numpy(boxes[order][None])
    valid = torch.from_numpy(scores[order][None] > valid_thresh)
    return box_nms.nms_keep(b, valid, thresh)[0].numpy()


@pytest.mark.parametrize("case", ["random", "ties", "all_suppressed",
                                  "at_threshold"])
def test_o4_plain_version_matches_jax_box_nms(case):
    rs = np.random.RandomState(11)
    n, thresh = 70, 0.5
    boxes = _boxes(rs, n)
    scores = rs.uniform(0, 1, n).astype(np.float32)
    if case == "ties":
        scores = (rs.randint(0, 4, n) / 4.0).astype(np.float32)
    elif case == "all_suppressed":
        # one box repeated: the first valid one suppresses all the rest
        boxes[:] = boxes[0]
        thresh = 0.1
    elif case == "at_threshold":
        # pairs whose IoU is exactly 0.5 in f32: [0,2]x[0,1] against
        # [0,2]x[0,2] and [1,3]x[0,1]... scaled by powers of two
        base = np.array([[0, 0, 2, 1], [0, 0, 2, 2], [0, 0, 1, 1],
                         [0, 0, 4, 1], [0, 0, 2, 1]], np.float32)
        boxes = np.concatenate([base * (2.0 ** -k) for k in range(14)])
        scores = np.linspace(1, 0.01, boxes.shape[0]).astype(np.float32)
    want = _jax_keep(boxes, scores, thresh)
    got = _o4_ref_keep(boxes, scores, thresh)
    assert got.dtype == np.bool_ and got.shape == want[np.argsort(
        -scores, kind="stable")].shape
    np.testing.assert_array_equal(got, want)
    if case == "all_suppressed":
        assert got.sum() == 1
    if case == "at_threshold":
        # IoU exactly 0.5 is not above the threshold: such pairs both stay
        assert got.sum() > boxes.shape[0] // 2


def test_o4_plain_version_drops_invalid_boxes_as_jax():
    rs = np.random.RandomState(12)
    boxes = _boxes(rs, 30)
    scores = rs.uniform(-0.5, 1, 30).astype(np.float32)
    np.testing.assert_array_equal(
        _o4_ref_keep(boxes, scores, 0.45, valid_thresh=0.2),
        _jax_keep(boxes, scores, 0.45, valid_thresh=0.2))


def test_o4_rejects_other_devices_and_shapes():
    with pytest.raises(MXNetError):
        box_nms.nms_keep(torch.zeros(2, 3), torch.zeros(2, 3, dtype=bool),
                         0.5)


# -- quantize, count sketch, encdec attention, hawkes ----------------------------------


@pytest.mark.parametrize("out_type", ["uint8", "int8"])
def test_quantize_and_dequantize_match_jax(out_type):
    x = _f32(4, 5) * 3
    lo, hi = np.array([-3.0], np.float32), np.array([2.5], np.float32)
    check_op("_contrib_quantize", [x, lo, hi], {"out_type": out_type},
             fwd=EXACT)
    q = np.asarray(jreg.get("_contrib_quantize").forward(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi),
        out_type=out_type)[0])
    check_op("_contrib_dequantize", [q, lo, hi], fwd=FWD)


def test_count_sketch_matches_jax():
    x = _f32(3, 10)
    h = np.random.RandomState(1).randint(0, 6, (1, 10)).astype(np.float32)
    s = np.random.RandomState(2).choice([-1.0, 1.0], (1, 10)) \
        .astype(np.float32)
    check_op("_contrib_count_sketch", [x, h, s], {"out_dim": 6}, diff=(0,))


def test_interleaved_encdec_matmuls_match_jax():
    q = _f32(5, 2, 2 * 4)
    kv = _f32(7, 2, 2 * 2 * 4, seed=1)
    check_op("_contrib_interleaved_matmul_encdec_qk", [q, kv], {"heads": 2},
             diff=(0, 1))
    att = _f32(4, 5, 7, seed=2)
    check_op("_contrib_interleaved_matmul_encdec_valatt", [kv, att],
             {"heads": 2}, diff=(0, 1))


@pytest.mark.parametrize("name", ["_contrib_hawkesll",
                                  "_contrib_backward_hawkesll"])
def test_hawkesll_matches_jax(name):
    rs = np.random.RandomState(5)
    n, t, k = 3, 6, 2
    lda = rs.uniform(0.5, 1.5, (n, k)).astype(np.float32)
    alpha = rs.uniform(0.1, 0.5, k).astype(np.float32)
    beta = rs.uniform(0.5, 2.0, k).astype(np.float32)
    state = rs.uniform(0, 1, (n, k)).astype(np.float32)
    lags = rs.uniform(0.1, 1.0, (n, t)).astype(np.float32)
    marks = rs.randint(0, k, (n, t)).astype(np.float32)
    vl = np.array([6, 3, 0], np.float32)
    mt = lags.sum(1).astype(np.float32) + 1
    check_op(name, [lda, alpha, beta, state, lags, marks, vl, mt],
             diff=(0, 1, 2), fwd=dict(rtol=1e-5, atol=1e-5))


# -- boolean_mask ------------------------------------------------------------------------


def test_boolean_mask_matches_jax_with_gradient():
    x = _f32(6, 3)
    m = np.array([1, 0, 1, 1, 0, 0.5], np.float32)
    with tmx.cpu():
        xs = tmx.nd.array(x)
        xs.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.contrib.boolean_mask(xs, tmx.nd.array(m))
            (y * y).sum().backward()
    np.testing.assert_array_equal(y.asnumpy(), x[m != 0])
    want = np.where((m != 0)[:, None], 2 * x, 0)
    np.testing.assert_allclose(xs.grad.asnumpy(), want, rtol=1e-6)
    got = treg.get("_contrib_boolean_mask").forward(
        torch.from_numpy(x.T.copy()), torch.from_numpy(m), axis=1)
    np.testing.assert_array_equal(got.numpy(), x.T[:, m != 0])


# -- the attention ops as registered ops ------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_op_matches_jax(causal):
    q, k, v = (_f32(1, 2, 8, 4, seed=s) for s in range(3))
    check_op("_contrib_flash_attention", [q, k, v], {"causal": causal},
             diff=(0, 1, 2))


def test_paged_attention_op_matches_jax():
    rs = np.random.RandomState(4)
    b, h, kv, d, s_page, pages = 2, 4, 2, 8, 4, 6
    q = rs.standard_normal((b, 1, h, d)).astype(np.float32)
    kp = rs.standard_normal((pages, s_page, kv, d)).astype(np.float32)
    vp = rs.standard_normal((pages, s_page, kv, d)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    pos = np.array([9, 5], np.int32)
    check_op("_contrib_paged_attention", [q, kp, vp, table, pos])
    with tmx.cpu():
        got = tmx.nd.contrib.paged_attention(
            tmx.nd.array(q), tmx.nd.array(kp), tmx.nd.array(vp),
            tmx.nd.array(table, dtype="int32"),
            tmx.nd.array(pos, dtype="int32"))
    want = np.asarray(jreg.get("_contrib_paged_attention").forward(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos))))
    np.testing.assert_allclose(got.asnumpy(), want, **FWD)


def test_contrib_namespace_lists_the_slice():
    names = dir(tmx.nd.contrib)
    for n in ("box_nms", "box_iou", "MultiBoxPrior", "MultiBoxTarget",
              "MultiBoxDetection", "fft", "boolean_mask", "flash_attention",
              "paged_attention", "foreach", "while_loop", "cond"):
        assert n in names, n
