"""The port's ``ops/vision.py`` against the JAX package's, on the CPU, and
the detection example's SSD end to end in both packages.

Every op goes through both packages' registered forwards on the same
seeded numpy inputs (``check_op``).  Ordering and indexing results are
bitwise equal: anchors, matching, NMS, ROI max pooling and the greedy
target assignment, ties included; f32 arithmetic (bilinear samples,
averages, the deformable convolution's contraction) within rtol 1e-5 /
atol 1e-5; gradients against ``jax.vjp`` of the JAX op within rtol
1e-4 / atol 1e-5.

The SSD (``examples/detection/train_ssd.py``'s blocks, the port's
written as the example writes them in ``chip_smoke.ssd_blocks``): the
JAX net's parameters carried across by ``vision.load_jax_params``, 64 x
64 images, batch 2; the recorded loss within 1e-5, every gradient
within 1e-4 of its tensor's largest, and the decoded detections
(``MultiBoxPrior``, softmax, ``MultiBoxDetection``) within 1e-5, their
classes and kept rows equal.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.ndarray  # noqa: F401  (registers every JAX op)
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.ops import registry as treg
import chip_smoke
from test_torch_ops_tensor import EXACT, _outs, check_op

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-5, atol=1e-5)


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def _rois(rs, n, batch, size, ndim=5):
    b = rs.randint(0, batch, (n, 1))
    xy = rs.uniform(0, size * 0.6, (n, 2))
    wh = rs.uniform(1, size * 0.4, (n, 2))
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


def _both(name, inputs, attrs):
    """Both packages' outputs of op ``name`` as numpy arrays."""
    got = treg.get(name).forward(*[torch.from_numpy(np.array(x))
                                   for x in inputs], **attrs)
    want = jreg.get(name).forward(*[jnp.asarray(x) for x in inputs], **attrs)
    return ([np.asarray(g) for g in _outs(got)],
            [np.asarray(w) for w in _outs(want)])


# -- the ROI family ----------------------------------------------------------------------


def test_roi_pooling_matches_jax_bitwise():
    rs = np.random.RandomState(0)
    data = _f32(2, 3, 12, 10)
    rois = _rois(rs, 5, 2, 10)
    check_op("ROIPooling", [data, rois], {"pooled_size": (3, 2),
                                          "spatial_scale": 0.8},
             diff=(0,), fwd=EXACT)
    check_op("roi_pooling", [data, rois], {"pooled_size": (2, 2)}, fwd=EXACT)


@pytest.mark.parametrize("kw", [{}, {"aligned": True, "sample_ratio": 3},
                                {"position_sensitive": True}])
def test_roi_align_matches_jax(kw):
    rs = np.random.RandomState(1)
    data = _f32(2, 8, 9, 11)
    rois = _rois(rs, 4, 2, 9)
    attrs = dict({"pooled_size": (2, 2), "spatial_scale": 0.9}, **kw)
    check_op("_contrib_ROIAlign", [data, rois], attrs, diff=(0,), fwd=F32)


def test_psroi_pooling_matches_jax():
    rs = np.random.RandomState(2)
    data = _f32(2, 2 * 3 * 3, 10, 10)
    rois = _rois(rs, 4, 2, 9)
    check_op("_contrib_PSROIPooling", [data, rois],
             {"output_dim": 2, "pooled_size": 3, "spatial_scale": 0.9},
             diff=(0,), fwd=F32)


@pytest.mark.parametrize("with_trans", [False, True])
def test_deformable_psroi_pooling_matches_jax(with_trans):
    rs = np.random.RandomState(3)
    data = _f32(2, 2 * 2 * 2, 9, 9)
    rois = _rois(rs, 3, 2, 8)
    attrs = {"output_dim": 2, "group_size": 2, "pooled_size": 2,
             "part_size": 2, "sample_per_part": 1, "trans_std": 0.1,
             "spatial_scale": 0.9}
    inputs = [data, rois]
    if with_trans:
        inputs.append(_f32(3, 2, 2, 2, seed=4))
    else:
        attrs["no_trans"] = True
    check_op("_contrib_DeformablePSROIPooling", inputs, attrs, diff=(0,),
             fwd=F32)


def test_rroi_align_matches_jax():
    rs = np.random.RandomState(5)
    data = _f32(2, 3, 10, 10)
    rois = np.concatenate([rs.randint(0, 2, (4, 1)),
                           rs.uniform(3, 7, (4, 2)), rs.uniform(2, 5, (4, 2)),
                           rs.uniform(-90, 90, (4, 1))], 1).astype(np.float32)
    check_op("_contrib_RROIAlign", [data, rois], {"pooled_size": (2, 3)},
             diff=(0,), fwd=F32)


def test_deformable_convolution_matches_jax():
    rs = np.random.RandomState(6)
    data = _f32(2, 4, 7, 7)
    offset = (rs.standard_normal((2, 2 * 2 * 3 * 3, 5, 5)) * 0.7) \
        .astype(np.float32)
    weight = _f32(6, 2, 3, 3, seed=7)
    bias = _f32(6, seed=8)
    check_op("_contrib_DeformableConvolution", [data, offset, weight, bias],
             {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
              "num_deformable_group": 2},
             diff=(0, 1, 2, 3), fwd=F32, grad=dict(rtol=1e-4, atol=1e-4))


# -- the SSD MultiBox ops -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"sizes": (0.3, 0.55, 0.8),
                                     "ratios": (1.0, 2.0, 0.5), "clip": True},
                                {"steps": (0.1, 0.12), "offsets": (0.3, 0.6)}])
def test_multibox_prior_matches_jax_bitwise(kw):
    check_op("_contrib_MultiBoxPrior", [np.zeros((1, 3, 5, 7), np.float32)],
             kw, fwd=EXACT)


def _labels(rs, b, g, n_valid):
    lab = np.full((b, g, 5), -1, np.float32)
    for i in range(b):
        for j in range(n_valid[i]):
            xy = rs.uniform(0, 0.6, 2)
            lab[i, j] = [rs.randint(0, 3), *xy, *(xy + rs.uniform(0.1, 0.4,
                                                                  2))]
    return lab


@pytest.mark.parametrize("mining", [False, True])
def test_multibox_target_matches_jax_bitwise(mining):
    rs = np.random.RandomState(9)
    anchors = np.asarray(jreg.get("_contrib_MultiBoxPrior").forward(
        jnp.zeros((1, 3, 6, 6)), sizes=(0.3, 0.55, 0.8),
        ratios=(1.0, 2.0, 0.5), clip=True))
    lab = _labels(rs, 3, 4, [2, 4, 0])
    pred = rs.standard_normal((3, 4, anchors.shape[1])).astype(np.float32)
    # ties in the hard-negative scores
    pred[:, 1:, ::7] = 0.75
    attrs = {"negative_mining_ratio": 3.0} if mining else {}
    # the regression targets take a log: f32 within its ulps; the masks
    # and the class targets (the matching and the ranking) bitwise
    check_op("_contrib_MultiBoxTarget", [anchors, lab, pred], attrs,
             fwd=F32)
    got, want = _both("_contrib_MultiBoxTarget", [anchors, lab, pred], attrs)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    if mining:
        assert (want[2] == -1).any() and (want[2] == 0).any()


def test_multibox_detection_matches_jax_bitwise():
    rs = np.random.RandomState(10)
    anchors = np.asarray(jreg.get("_contrib_MultiBoxPrior").forward(
        jnp.zeros((1, 3, 5, 5)), sizes=(0.3, 0.55), ratios=(1.0, 2.0)))
    a = anchors.shape[1]
    logits = rs.standard_normal((2, 4, a)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.standard_normal((2, a * 4)) * 0.2).astype(np.float32)
    attrs = {"nms_threshold": 0.45, "threshold": 0.2}
    # the boxes take an exp: f32 within its ulps; the classes, scores,
    # order and kept rows bitwise
    check_op("_contrib_MultiBoxDetection", [prob, loc, anchors], attrs,
             fwd=F32)
    (got,), (want,) = _both("_contrib_MultiBoxDetection",
                            [prob, loc, anchors], attrs)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    assert (want[..., 0] == -1).any() and (want[..., 0] >= 0).any()


def test_box_encode_and_decode_match_jax():
    rs = np.random.RandomState(11)
    anchors = np.stack([_rois(rs, 6, 1, 1.0)[:, 1:] for _ in range(2)])
    refs = np.stack([_rois(rs, 3, 1, 1.0)[:, 1:] for _ in range(2)])
    samples = rs.uniform(0, 1, (2, 6)).astype(np.float32)
    matches = rs.randint(-1, 3, (2, 6)).astype(np.float32)
    check_op("_contrib_box_encode", [samples, matches, anchors, refs],
             fwd=F32)
    check_op("_contrib_box_encode", [samples, matches, anchors, refs],
             {"means": (0.1, 0.0, -0.1, 0.2), "stds": (1.0, 0.5, 2.0, 0.25)},
             fwd=F32)
    deltas = (rs.standard_normal((2, 6, 4)) * 0.3).astype(np.float32)
    check_op("_contrib_box_decode", [deltas, anchors[0]], diff=(0,),
             fwd=F32)
    check_op("_contrib_box_decode", [deltas, anchors[0]],
             {"std0": 0.1, "std2": 0.2, "clip": 0.25, "format": "center"},
             fwd=F32)


@pytest.mark.parametrize("kw", [{}, {"is_ascend": True, "threshold": 0.4},
                                {"topk": 2, "threshold": 0.1}])
def test_bipartite_matching_matches_jax_bitwise(kw):
    rs = np.random.RandomState(12)
    scores = rs.uniform(0, 1, (2, 5, 4)).astype(np.float32)
    scores[0, 1, 2] = scores[0, 3, 0] = scores.max() + 0.01    # a tie
    check_op("_contrib_bipartite_matching", [scores], kw, fwd=EXACT)


@pytest.mark.parametrize("name", ["_contrib_Proposal",
                                  "_contrib_MultiProposal"])
def test_proposal_matches_jax(name):
    rs = np.random.RandomState(13)
    a, fh, fw = 6, 4, 5
    cls_prob = rs.uniform(0, 1, (2, 2 * a, fh, fw)).astype(np.float32)
    bbox = (rs.standard_normal((2, 4 * a, fh, fw)) * 0.2).astype(np.float32)
    im_info = np.array([[64, 80, 1.0], [60, 70, 0.8]], np.float32)
    check_op(name, [cls_prob, bbox, im_info],
             {"rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 12,
              "threshold": 0.6, "rpn_min_size": 4, "scales": (2, 4),
              "ratios": (0.5, 1, 2), "feature_stride": 16},
             fwd=dict(rtol=1e-5, atol=1e-4))


def test_mrcnn_mask_target_matches_jax():
    rs = np.random.RandomState(14)
    rois = np.stack([_rois(rs, 4, 1, 12)[:, 1:] for _ in range(2)])
    masks = (rs.uniform(0, 1, (2, 3, 12, 12)) > 0.5).astype(np.float32)
    matches = rs.randint(0, 3, (2, 4)).astype(np.float32)
    cls = rs.randint(0, 3, (2, 4)).astype(np.float32)
    check_op("_contrib_mrcnn_mask_target", [rois, masks, matches, cls],
             {"num_classes": 3, "mask_size": (5, 4)}, fwd=F32)


@pytest.mark.parametrize("mode", ["train", "predict"])
def test_sync_batch_norm_is_batch_norm_as_in_jax(mode):
    rs = np.random.RandomState(15)
    x = rs.standard_normal((4, 3, 5, 5)).astype(np.float32)
    gamma, beta = rs.uniform(0.5, 1.5, 3).astype(np.float32), _f32(3)
    mm, mv = _f32(3, seed=2) * 0.1, rs.uniform(0.5, 2, 3).astype(np.float32)
    check_op("_contrib_SyncBatchNorm", [x, gamma, beta, mm, mv],
             {"_mode": mode, "fix_gamma": False, "ndev": 1},
             diff=(0, 1, 2), fwd=dict(rtol=1e-5, atol=1e-5),
             grad=dict(rtol=1e-4, atol=1e-4))


def test_sparse_embedding_is_embedding():
    ids = np.array([[0, 3], [2, 1]], np.float32)
    w = _f32(4, 5)
    check_op("_contrib_SparseEmbedding", [ids, w],
             {"input_dim": 4, "output_dim": 5}, diff=(1,), fwd=EXACT)
    assert treg.get("_contrib_SparseEmbedding") is treg.get("Embedding")


# -- the detection example's SSD end to end ---------------------------------------------


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "train_ssd_example",
        os.path.join(REPO, "examples", "detection", "train_ssd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ssd_pair():
    """The JAX example's SSD and the port's, same weights, one recorded
    loss and backward each, on 64 x 64 images, batch 2."""
    ex = _jax_example()
    assert ex.NUM_ANCHORS == chip_smoke.SSD_ANCHORS
    assert (ex.SIZES, ex.RATIOS) == (chip_smoke.SSD_SIZES,
                                     chip_smoke.SSD_RATIOS)
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    lab = np.full((2, 3, 5), -1, np.float32)
    lab[0, 0] = [0, .1, .1, .5, .6]
    lab[0, 1] = [1, .4, .3, .9, .8]
    lab[1, 0] = [1, .2, .5, .7, .9]
    mx.random.seed(0)
    jnet = ex.SSDNet(2, ex.NUM_ANCHORS)
    jnet.initialize(mx.init.Xavier())
    jx, jl = jnd.array(x), jnd.array(lab)
    jnet(jx)                            # the deferred shapes
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    with jautograd.record():
        jloss = ex.SSDTrainLoss(jnet)(jx, jl)
    jloss.backward()
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()
              if p.grad_req != "null"}
    SSDNet, SSDTrainLoss = chip_smoke.ssd_blocks()
    with tmx.cpu():
        tnet = SSDNet(2, chip_smoke.SSD_ANCHORS, device="cpu")
        tnet.initialize()
        tx, tl = tmx.nd.array(x), tmx.nd.array(lab)
        tnet(tx)
        vision.load_jax_params(tnet, params, layout="NCHW")
        with tmx.autograd.record():
            tloss = SSDTrainLoss(tnet)(tx, tl)
        tloss.backward()
    return dict(ex=ex, x=x, lab=lab, params=params, jnet=jnet, tnet=tnet,
                jloss=jloss.asnumpy(), tloss=tloss.asnumpy(), jgrads=jgrads,
                SSDTrainLoss=SSDTrainLoss)


def test_ssd_recorded_loss_and_gradients_match_jax(ssd_pair):
    p = ssd_pair
    np.testing.assert_allclose(p["tloss"], p["jloss"], rtol=1e-5)
    handles = p["tnet"]._param_handles()
    assert set(p["jgrads"]) <= set(handles)
    for name, want in p["jgrads"].items():
        got = handles[name]._tensor.grad
        assert got is not None, name
        got = got.numpy()
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-4 * scale, name


def test_ssd_decoded_detections_match_jax(ssd_pair):
    p = ssd_pair
    ex = p["ex"]
    feat, cls, loc = p["jnet"](jnd.array(p["x"]))
    anchors = jnd.contrib.MultiBoxPrior(feat, sizes=ex.SIZES,
                                        ratios=ex.RATIOS, clip=True)
    probs = jnd.softmax(cls.transpose((0, 2, 1))).transpose((0, 2, 1))
    want = jnd.contrib.MultiBoxDetection(probs, loc, anchors,
                                         nms_threshold=0.45,
                                         threshold=0.01).asnumpy()
    with tmx.cpu():
        feat, cls, loc = p["tnet"](tmx.nd.array(p["x"]))
        anchors = tmx.nd.contrib.MultiBoxPrior(
            feat, sizes=chip_smoke.SSD_SIZES, ratios=chip_smoke.SSD_RATIOS,
            clip=True)
        probs = tmx.nd.softmax(cls.transpose((0, 2, 1))).transpose((0, 2, 1))
        got = tmx.nd.contrib.MultiBoxDetection(
            probs, loc, anchors, nms_threshold=0.45, threshold=0.01)
    got = got.asnumpy()
    assert got.shape == want.shape == (2, 8 * 8 * chip_smoke.SSD_ANCHORS, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1] == -1, want[..., 1] == -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ssd_train_step_on_the_host_matches_the_recorded_loss(ssd_pair):
    """One ``JitTrainStep(SSDTrainLoss(net), None, "adam")`` step of the
    port (eager on the host) from the same weights gives the recorded
    loss, and moves the weights."""
    p = ssd_pair
    from mxnet_tpu_torch import parallel

    SSDNet, SSDTrainLoss = chip_smoke.ssd_blocks()
    with tmx.cpu():
        net = SSDNet(2, chip_smoke.SSD_ANCHORS, device="cpu")
        net.initialize()
        net(tmx.nd.array(p["x"]))
        vision.load_jax_params(net, p["params"], layout="NCHW")
        before = net.cls_pred.weight.detach().clone()
        step = parallel.JitTrainStep(SSDTrainLoss(net), None, "adam",
                                     {"learning_rate": 1e-3})
        loss = step.step(torch.from_numpy(p["x"]), torch.from_numpy(p["lab"]))
    np.testing.assert_allclose(float(loss), p["jloss"][0], rtol=1e-5)
    assert not torch.equal(before, net.cls_pred.weight.detach())
