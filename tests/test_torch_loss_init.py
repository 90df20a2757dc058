"""The port's losses and initializers against the JAX package's, on the
CPU: the 13 losses of ``gluon/loss.py`` beside ``SoftmaxCrossEntropyLoss``
(with ``weight``, ``sample_weight`` and both ``batch_axis`` values),
the ``CTCLoss`` op and loss (the blank first and last, padded labels,
``use_*_lengths``, both layouts, the gradient), the ops the JAX
package's losses call that the port lacked (``where``, ``one_hot``)
through ``nd``, and the initializers ``InitDesc``, ``Orthogonal``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``FusedRNN``, ``Load`` and
``Mixed``.

Inputs come from numpy seeds and go to both packages.  Tolerances
(f32): the losses rtol 1e-5 / atol 1e-6 (``CTCLoss`` 1e-4 relative: the
JAX package runs its own scan in log space, the port ``F.ctc_loss``;
its gradient 1e-4 of the largest); the deterministic initializers are
equal; the random ones (threefry against Philox) are held to their
defining properties: orthonormal rows or columns within 1e-5, and the
standard deviation within 3% of the rule's (65,536 draws).
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import initializer as jinit
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, initializer
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)
B, D = 4, 6


def _rs(seed):
    return np.random.RandomState(seed)


def _shape(batch_axis, *rest):
    """(B, D, ...) with the batch on ``batch_axis``."""
    dims = [D] + list(rest)
    dims.insert(batch_axis, B)
    return tuple(dims)


def _sample_weight(batch_axis, ndim):
    shape = [1] * ndim
    shape[batch_axis] = B
    return _rs(9).uniform(0.5, 1.5, shape).astype(np.float32)


def _pair_inputs(kind, batch_axis, seed=0):
    rs = _rs(seed)
    shape = _shape(batch_axis)
    pred = rs.standard_normal(shape).astype(np.float32)
    if kind == "prob":
        pred = 1.0 / (1.0 + np.exp(-pred))
        label = rs.randint(0, 2, shape).astype(np.float32)
    elif kind == "binary":
        label = rs.randint(0, 2, shape).astype(np.float32)
    elif kind == "signed":
        label = (2 * rs.randint(0, 2, shape) - 1).astype(np.float32)
    elif kind == "dist":
        label = rs.uniform(0.1, 1.0, shape).astype(np.float32)
        label /= label.sum(axis=-1, keepdims=True)
        pred = np.log(rs.uniform(0.1, 1.0, shape).astype(np.float32))
    elif kind == "count":
        label = rs.poisson(2.0, shape).astype(np.float32)
    else:
        label = rs.standard_normal(shape).astype(np.float32)
    return [pred, label]


# (loss name, constructor kwargs, input kind)
PAIR_LOSSES = [
    ("L2Loss", {}, "real"),
    ("L2Loss", {"weight": 0.7}, "real"),
    ("L1Loss", {"weight": 2.0}, "real"),
    ("SigmoidBinaryCrossEntropyLoss", {"weight": 0.5}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob"),
    ("KLDivLoss", {}, "dist"),
    ("KLDivLoss", {"from_logits": False, "weight": 1.5}, "dist"),
    ("HuberLoss", {"rho": 0.5, "weight": 2.0}, "real"),
    ("HingeLoss", {"margin": 0.5}, "signed"),
    ("SquaredHingeLoss", {"weight": 0.3}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary", "weight": 2.0}, "binary"),
    ("PoissonNLLLoss", {}, "count"),
    ("PoissonNLLLoss", {"compute_full": True, "weight": 0.5}, "count"),
    ("PoissonNLLLoss", {"from_logits": False}, "count"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dist"),
]


def _jax(name, kwargs):
    return getattr(jgluon.loss, name)(**kwargs)


def _port(name, kwargs):
    return getattr(gluon.loss, name)(**kwargs)


def _both(name, kwargs, inputs, extra=()):
    """The JAX package's and the port's loss on the same arrays."""
    want = _jax(name, kwargs)(*[nd.array(a) for a in inputs + list(extra)])
    got = _port(name, kwargs)(*[torch.from_numpy(a)
                                for a in inputs + list(extra)])
    return got.detach().numpy(), want.asnumpy()


@pytest.mark.parametrize("batch_axis", [0, 1])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "sample_weight"])
@pytest.mark.parametrize("name,kwargs,kind", PAIR_LOSSES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(PAIR_LOSSES)])
def test_pair_losses_match_jax(name, kwargs, kind, weighted, batch_axis):
    inputs = _pair_inputs(kind, batch_axis)
    kw = dict(kwargs, batch_axis=batch_axis)
    if name == "PoissonNLLLoss" and kind == "count" \
            and not kwargs.get("from_logits", True):
        inputs[0] = np.abs(inputs[0])
    extra = [_sample_weight(batch_axis, 2)] if weighted else []
    got, want = _both(name, kw, inputs, extra)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_sigmoid_bce_pos_weight_matches_jax(batch_axis):
    pred, label = _pair_inputs("binary", batch_axis)
    pos = _rs(3).uniform(0.5, 3.0, _shape(batch_axis)).astype(np.float32)
    for from_sigmoid in (False, True):
        p = pred if not from_sigmoid else 1 / (1 + np.exp(-pred))
        kw = {"from_sigmoid": from_sigmoid, "batch_axis": batch_axis}
        want = _jax("SigmoidBCELoss", kw)(nd.array(p), nd.array(label),
                                          None, nd.array(pos))
        got = _port("SigmoidBCELoss", kw)(torch.from_numpy(p),
                                          torch.from_numpy(label), None,
                                          torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), want.asnumpy(), **TOL)


@pytest.mark.parametrize("batch_axis", [0, 1])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "sample_weight"])
def test_triplet_loss_matches_jax(weighted, batch_axis):
    rs = _rs(4)
    shape = _shape(batch_axis, 3)
    pred, pos, neg = (rs.standard_normal(shape).astype(np.float32)
                      for _ in range(3))
    kw = {"margin": 0.5, "weight": 1.5, "batch_axis": batch_axis}
    extra = []
    if weighted:
        extra = [_rs(5).uniform(0.5, 1.5, (B, 1) if batch_axis == 0
                                else (D, B)).astype(np.float32)]
    got, want = _both("TripletLoss", kw, [pred, pos, neg], extra)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("batch_axis", [0, 1])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "sample_weight"])
def test_cosine_embedding_loss_matches_jax(weighted, batch_axis):
    rs = _rs(6)
    x1 = rs.standard_normal((B, D)).astype(np.float32)
    x2 = rs.standard_normal((B, D)).astype(np.float32)
    x2[0] = 0.0                       # a zero norm: the 1e-12 floor
    label = np.array([1, -1, 1, -1], np.float32)
    kw = {"margin": 0.2, "weight": 2.0, "batch_axis": batch_axis}
    extra = [_rs(7).uniform(0.5, 1.5, (B, 1)).astype(np.float32)] \
        if weighted else []
    got, want = _both("CosineEmbeddingLoss", kw, [x1, x2, label], extra)
    np.testing.assert_allclose(got, want, **TOL)


def test_sdml_loss_matches_jax():
    rs = _rs(8)
    x1 = rs.standard_normal((5, D)).astype(np.float32)
    x2 = (x1 + 0.3 * rs.standard_normal((5, D))).astype(np.float32)
    for s in (0.3, 0.1):
        got, want = _both("SDMLLoss", {"smoothing_parameter": s}, [x1, x2])
        np.testing.assert_allclose(got, want, **TOL)


def test_loss_gradients_match_jax():
    """The input gradient of a weighted sum of five losses."""
    pred, label = _pair_inputs("signed", 0)
    names = ("L2Loss", "L1Loss", "HuberLoss", "SquaredHingeLoss",
             "LogisticLoss")
    pj = nd.array(pred)
    pj.attach_grad()
    with autograd.record():
        total = sum(_jax(n, {})(pj, nd.array(label)).sum() * (i + 1)
                    for i, n in enumerate(names))
    total.backward()
    pt = torch.from_numpy(pred).requires_grad_()
    total_t = sum(_port(n, {})(pt, torch.from_numpy(label)).sum() * (i + 1)
                  for i, n in enumerate(names))
    total_t.backward()
    np.testing.assert_allclose(pt.grad.numpy(), pj.grad.asnumpy(), **TOL)


def test_weight_must_be_a_number_and_label_format_checked():
    x = torch.ones(2, 3)
    with pytest.raises(MXNetError, match="number"):
        gluon.loss.L1Loss(weight=torch.ones(1))(x, x)
    with pytest.raises(MXNetError, match="signed or binary"):
        gluon.loss.LogisticLoss(label_format="zero_one")
    with pytest.raises(MXNetError, match="layout"):
        gluon.loss.CTCLoss(layout="NCT")
    assert gluon.loss.SigmoidBCELoss \
        is gluon.loss.SigmoidBinaryCrossEntropyLoss


# -- CTC -------------------------------------------------------------------

T, C, L = 12, 6, 4


def _ctc_inputs(seed, blank_last):
    """Logits (T, B, C), labels (B, L) padded with -1 (blank last) or 0
    (blank first), data and label lengths."""
    rs = _rs(seed)
    data = rs.standard_normal((T, B, C)).astype(np.float32)
    lab_len = np.array([4, 2, 3, 1], np.int64)
    lo, hi = (0, C - 1) if blank_last else (1, C)
    labels = rs.randint(lo, hi, (B, L)).astype(np.float32)
    labels[1, 1] = labels[1, 0]                  # a repeated label
    for b, n in enumerate(lab_len):
        labels[b, n:] = -1 if blank_last else 0
    dat_len = np.array([12, 9, 10, 5], np.float32)
    return data, labels, dat_len, lab_len.astype(np.float32)


def _ctc_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("lengths", ["none", "data", "label", "both"])
def test_ctc_op_matches_jax(blank, lengths):
    data, labels, dl, ll = _ctc_inputs(1, blank == "last")
    use_d, use_l = lengths in ("data", "both"), lengths in ("label", "both")
    kw = dict(use_data_lengths=use_d, use_label_lengths=use_l,
              blank_label=blank)
    args = [data, labels, dl if use_d else None, ll if use_l else None]
    want = nd.CTCLoss(*[None if a is None else nd.array(a) for a in args],
                      **kw)
    got = tmx.nd.CTCLoss(*[None if a is None else tmx.nd.array(
        a, ctx=tmx.cpu()) for a in args], **kw)
    assert len(got) == 2 and got[1].shape == data.shape
    _ctc_close(got[0].asnumpy(), want[0].asnumpy())
    assert np.all(got[1].asnumpy() == 0)
    # the registered alias
    alias = tmx.nd.ctc_loss(*[None if a is None else tmx.nd.array(
        a, ctx=tmx.cpu()) for a in args], **kw)
    np.testing.assert_array_equal(alias[0].asnumpy(), got[0].asnumpy())


@pytest.mark.parametrize("layout,label_layout",
                         [("NTC", "NT"), ("TNC", "TN"), ("NTC", "TN")])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "sample_weight"])
def test_ctc_loss_block_matches_jax(layout, label_layout, weighted):
    """Gluon's CTCLoss passes the blank last: labels padded with -1;
    with lengths given, the padding is not read.  The loss and the
    logits' gradient."""
    data, labels, dl, ll = _ctc_inputs(2, True)
    if layout == "NTC":
        data = data.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        labels = labels.T.copy()
    sw = _rs(3).uniform(0.5, 1.5, (B,)).astype(np.float32)
    for with_lengths in (False, True):
        extra = [dl, ll] if with_lengths else [None, None]
        if weighted:
            extra.append(sw)
        jl = jgluon.loss.CTCLoss(layout=layout, label_layout=label_layout,
                                 weight=0.5)
        dj = nd.array(data)
        dj.attach_grad()
        with autograd.record():
            want = jl(dj, nd.array(labels),
                      *[None if a is None else nd.array(a) for a in extra])
        want.backward()
        tl = gluon.loss.CTCLoss(layout=layout, label_layout=label_layout,
                                weight=0.5)
        dt = torch.from_numpy(data).requires_grad_()
        got = tl(dt, torch.from_numpy(labels),
                 *[None if a is None else torch.from_numpy(a)
                   for a in extra])
        got.sum().backward()
        _ctc_close(got.detach().numpy(), want.asnumpy())
        g, w = dt.grad.numpy(), dj.grad.asnumpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_loss_ops_match_jax():
    rs = _rs(11)
    x = rs.standard_normal((3, 5)).astype(np.float32) * 2
    cond = (rs.standard_normal((3, 5)) > 0).astype(np.float32)
    y = rs.standard_normal((3, 5)).astype(np.float32)
    cases = [("where", [cond, x, y], {}),
             ("one_hot", [np.array([0, 2, 7, 1], np.float32)],
              {"depth": 4, "on_value": 2.0, "off_value": -1.0})]
    for name, args, attrs in cases:
        want = getattr(nd, name)(*[nd.array(a) for a in args], **attrs)
        got = getattr(tmx.nd, name)(*[tmx.nd.array(a, ctx=tmx.cpu())
                                      for a in args], **attrs)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


# -- initializers ----------------------------------------------------------

def _fill(init, name, shape, seed=0):
    t = torch.empty(shape)
    init(name, t, generator=torch.Generator().manual_seed(seed))
    return t.numpy()


def _jax_fill(init, name, shape):
    return np.asarray(init(name, shape))


def test_bilinear_lstm_bias_and_fused_rnn_equal_jax():
    shape = (2, 3, 5, 4)
    np.testing.assert_array_equal(
        _fill(initializer.Bilinear(), "up_weight", shape),
        _jax_fill(jinit.Bilinear(), jinit.InitDesc("up_weight"), shape))
    for fb in (1.0, 2.5):
        t_init, j_init = initializer.LSTMBias(fb), jinit.LSTMBias(fb)
        # through InitDesc's __init__, as a bias name alone gives zeros
        got = _fill(initializer.Uniform(), initializer.InitDesc(
            "lstm_i2h_bias", attrs={"__init__": t_init.dumps()}), (16,))
        want = _jax_fill(jinit.Uniform(), jinit.InitDesc(
            "lstm_i2h_bias", attrs={"__init__": j_init.dumps()}), (16,))
        np.testing.assert_array_equal(got, want)
        assert got[4:8].tolist() == [fb] * 4 and got[:4].tolist() == [0] * 4
        np.testing.assert_array_equal(
            _fill(t_init, "lstm_i2h_bias", (8,)),
            _jax_fill(j_init, jinit.InitDesc("lstm_i2h_bias"), (8,)))
    fused = initializer.FusedRNN(initializer.Constant(0.3), 4, 1)
    np.testing.assert_array_equal(
        _fill(fused, "rnn_parameters", (20,)),
        _jax_fill(jinit.FusedRNN(jinit.Constant(0.3), 4, 1),
                  jinit.InitDesc("rnn_parameters"), (20,)))
    u = _fill(initializer.FusedRNN(), "rnn_parameters", (4096,))
    assert np.abs(u).max() <= 0.1 and np.abs(u).max() > 0.09


def test_init_desc_dumps_and_name_rules_match_jax():
    shape = (3, 4)
    for name in ("fc_weight", "fc_bias", "bn_gamma", "bn_beta",
                 "bn_running_mean", "bn_running_var", "bn_moving_mean",
                 "bn_moving_var"):
        want = _jax_fill(jinit.Constant(0.25), jinit.InitDesc(name), shape)
        got = _fill(initializer.Constant(0.25), name, shape)
        np.testing.assert_array_equal(got, want)
    desc = initializer.InitDesc("w", attrs={"__init__": "one"})
    assert desc == "w" and desc.attrs == {"__init__": "one"}
    np.testing.assert_array_equal(_fill(initializer.Zero(), desc, shape),
                                  np.ones(shape, np.float32))
    x = initializer.Xavier(rnd_type="gaussian", magnitude=2)
    again = initializer.create(x.dumps())
    assert type(again) is initializer.Xavier and again._kwargs == x._kwargs
    assert x.dumps() == jinit.Xavier(rnd_type="gaussian",
                                     magnitude=2).dumps()
    assert type(initializer.create(["msraprelu", {"slope": 0.1}])) \
        is initializer.MSRAPrelu


def test_load_and_mixed_match_jax():
    rs = _rs(12)
    arrays = {"arg:fc_weight": rs.standard_normal((3, 4)).astype(np.float32),
              "aux:bn_running_mean": rs.standard_normal(4).astype(np.float32)}
    t_load = initializer.Load(
        {k: tmx.nd.array(v, ctx=tmx.cpu()) if k.startswith("arg") else v
         for k, v in arrays.items()}, default_init=initializer.One())
    j_load = jinit.Load({k: nd.array(v) for k, v in arrays.items()},
                        default_init=jinit.One())
    for name, shape in (("fc_weight", (3, 4)), ("bn_running_mean", (4,)),
                        ("other_weight", (2, 2))):
        np.testing.assert_array_equal(
            _fill(t_load, name, shape),
            _jax_fill(j_load, jinit.InitDesc(name), shape))
    with pytest.raises(MXNetError, match="shape mismatch"):
        _fill(t_load, "fc_weight", (4, 3))
    with pytest.raises(MXNetError, match="no init"):
        _fill(initializer.Load({}), "fc_weight", (2,))
    t_mixed = initializer.Mixed([".*bias", ".*"],
                                [initializer.Constant(0.5),
                                 initializer.Constant(-2.0)])
    j_mixed = jinit.Mixed([".*bias", ".*"],
                          [jinit.Constant(0.5), jinit.Constant(-2.0)])
    for name in ("fc_bias", "fc_weight"):
        # the dispatch picks the initializer; its name rule then applies
        np.testing.assert_array_equal(
            _fill(t_mixed, name, (3,)),
            _jax_fill(j_mixed, jinit.InitDesc(name), (3,)))
    with pytest.raises(MXNetError, match="no matching pattern"):
        _fill(initializer.Mixed(["fc.*"], [initializer.One()]), "bn_x", (2,))
    with pytest.raises(MXNetError, match="pair up"):
        initializer.Mixed([".*"], [])


@pytest.mark.parametrize("shape", [(16, 64), (64, 16), (8, 4, 3, 3)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthonormal_as_in_jax(shape, rand_type):
    scale = 1.414
    got = _fill(initializer.Orthogonal(scale, rand_type), "w_weight", shape)
    mx.random.seed(1)
    want = _jax_fill(jinit.Orthogonal(scale, rand_type),
                     jinit.InitDesc("w_weight"), shape)
    for q in (got, want):
        m = q.reshape(shape[0], -1).astype(np.float64) / scale
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)
    assert got.shape == want.shape


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_msra_prelu_variance_matches_jax(factor_type):
    shape, slope = (256, 64, 2, 2), 0.25
    fan_in, fan_out = 64 * 4, 256 * 4
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    std = math.sqrt(2.0 / (1 + slope ** 2) / factor)
    got = _fill(initializer.MSRAPrelu(factor_type, slope), "c_weight", shape)
    mx.random.seed(2)
    want = _jax_fill(jinit.MSRAPrelu(factor_type, slope),
                     jinit.InitDesc("c_weight"), shape)
    for a in (got, want):
        assert abs(a.std() / std - 1) < 0.03
        assert abs(a.mean()) < 0.03 * std
    assert initializer.MSRAPrelu(factor_type, slope).dumps() == \
        jinit.MSRAPrelu(factor_type, slope).dumps()


def test_initializers_fill_gluon_parameters_through_initialize():
    """``Block.initialize`` with a ``Mixed`` over a ``Load`` (the port's
    ``create`` passes both through; the JAX package calls them only
    directly): the weight from the dict by its prefixed name, the bias
    by the name rule."""
    net = gluon.nn.Dense(3, in_units=2, device="cpu")
    (wname,) = [k for k in net.collect_params() if k.endswith("weight")]
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    net.initialize(initializer.Mixed(
        [".*weight", ".*"],
        [initializer.Load({wname: w}), initializer.Constant(3.0)]))
    got = {k: t.detach().numpy() for k, t in
           net._collect_params_with_prefix().items()}
    np.testing.assert_array_equal(got["weight"], w)
    np.testing.assert_array_equal(got["bias"], np.zeros(3, np.float32))
