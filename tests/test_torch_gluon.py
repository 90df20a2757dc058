"""The port's Gluon parameter layer and Block API against the JAX
package's, on the CPU: ``Parameter``, ``Constant`` and
``ParameterDict``; ``collect_params()`` names (prefixes, name scopes,
the global counter) for a name-scoped ``HybridSequential``,
``bert_small``, ``resnet18_v1`` and ``llama_small``; ``nd.save``'s
bytes and ``.params`` files crossing both ways through
``save_parameters``/``load_parameters`` with the JAX package's
fallbacks; ``grad_req`` ``"add"``/``"null"``, ``lr_mult``/``wd_mult``
through ``gluon.Trainer``; forward hooks, ``apply``, ``summary`` and
``infer_shape``; NDArrays through blocks; ``gluon.utils``; and a
``train_mnist.py``-shaped loop.

Inputs and weights come from numpy seeds; weights cross through
``.params`` files or ``set_data``.  Each package's block-name counter is
reset per test (``monkeypatch`` on its ``gluon.block._name_counter``).

Tolerances: f32 outputs rtol 1e-5 / atol 1e-5 (a whole net's within 1e-5
of its largest output); gradients and weights
after optimizer steps rtol 1e-4 / atol 1e-4 (adamw 1e-4 of the largest
value); names, bytes, orders, counts and printed summaries exact.
"""
import hashlib
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import llama as jllama
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert, llama, vision

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _fresh_names(monkeypatch):
    """Both packages' block-name counters start at zero."""
    monkeypatch.setattr(jblock, "_name_counter", {})
    monkeypatch.setattr(tblock, "_name_counter", {})
    with CPU:
        yield


def _close(got, want, rel=1e-5):
    """Equal within ``rel`` of ``want``'s largest magnitude."""
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(np.asarray(got, np.float64) - want).max() / scale
    assert err <= rel, "error %.3g of the largest value > %.3g" % (err, rel)


def _mlp(pkg_nn, act="relu"):
    net = pkg_nn.HybridSequential()
    with net.name_scope():
        net.add(pkg_nn.Dense(8, activation=act))
        net.add(pkg_nn.Dense(3))
    return net


# -- Parameter, Constant, ParameterDict ---------------------------------------

def test_parameter_matches_jax():
    for g in (jgluon, gluon):
        p = g.Parameter("weight", shape=(10, 10))
        p.initialize(init="xavier")
        assert p.data().shape == (10, 10)
        assert p.grad().shape == (10, 10)
        assert not p.grad().asnumpy().any()
        assert p.name == "weight" and p.grad_req == "write"
        p.grad_req = "null"
        with pytest.raises(Exception, match="null"):
            p.grad()
        with pytest.raises(Exception, match="grad_req"):
            p.grad_req = "sometimes"
    tp = gluon.Parameter("w", shape=(2, 3))
    tp.initialize(ctx=CPU)
    assert tp.list_ctx() == [CPU] and len(tp.list_data()) == 1
    # data() is an NDArray over the tensor itself: set_data writes in place
    t = tp._tensor
    tp.set_data(np.ones((2, 3), np.float32))
    assert tp._tensor is t and float(t.detach().sum()) == 6.0
    assert tp.data()._data is t
    with pytest.raises(MXNetError, match="S9"):
        tp.var()


def test_parameter_deferred_matches_jax():
    for g in (jgluon, gluon):
        p = g.Parameter("weight", shape=(10, 0), allow_deferred_init=True)
        p.initialize()
        with pytest.raises(g.DeferredInitializationError):
            p.data()
        p.shape = (10, 5)
        p._finish_deferred_init()
        assert p.data().shape == (10, 5)
        q = g.Parameter("weight", shape=(10, 0))
        with pytest.raises(Exception, match="unknown shape"):
            q.initialize()
        with pytest.raises(Exception, match="cannot reset shape"):
            p.shape = (10, 6)


@pytest.mark.parametrize("value", [[[1, 2], [3, 4]], [[1.5, 2.5]]])
def test_constant_matches_jax(value):
    jc, tc = jgluon.Constant("const", value), gluon.Constant("const", value)
    jc.initialize()
    tc.initialize()
    assert tc.grad_req == jc.grad_req == "null"
    assert str(tc.dtype) == str(jc.dtype)
    np.testing.assert_array_equal(tc.data().asnumpy(), jc.data().asnumpy())


def test_parameterdict_matches_jax():
    for g in (jgluon, gluon):
        params = g.ParameterDict("net_")
        w = params.get("weight", shape=(10, 10))
        assert w.name == "net_weight" and params.get("weight") is w
        c = params.get_constant("c", [1.0, 2.0])
        assert params.get_constant("c") is c
        assert list(params.keys()) == ["net_weight", "net_c"]
        params.setattr("lr_mult", 0.5)
        assert w.lr_mult == c.lr_mult == 0.5
        other = g.ParameterDict("net_")
        other.get("weight", shape=(10, 10))
        with pytest.raises(Exception, match="duplicate"):
            params.update(other)
        shared = g.ParameterDict("x_", shared=params)
        assert shared.get("weight", shape=(10, 10)) is not w
        with pytest.raises(Exception, match="no constant"):
            params.get_constant("missing")


def test_collect_params_select_and_setattr_match_jax():
    jnet, net = _mlp(jnn), _mlp(nn)
    for n in (jnet, net):
        sel = n.collect_params(".*bias|.*gamma|.*beta")
        assert list(sel.keys()) == ["hybridsequential0_dense0_bias",
                                    "hybridsequential0_dense1_bias"]
        sel.setattr("wd_mult", 0.0)
        assert [p.wd_mult for p in n.collect_params().values()] == \
            [1.0, 0.0, 1.0, 0.0]


# -- names -----------------------------------------------------------------------

def _named_nets(kind):
    if kind == "sequential":
        return _mlp(jnn, "tanh"), _mlp(nn, "tanh")
    if kind == "bert_small":
        return jbert.bert_small(), bert.bert_small(device="cpu")
    if kind == "resnet18_v1":
        return (jvision.resnet18_v1(layout="NCHW", classes=10),
                vision.resnet18_v1(layout="NCHW", classes=10, device="cpu"))
    return jllama.llama_small(), llama.llama_small(device="cpu")


@pytest.mark.parametrize("kind", ["sequential", "bert_small", "resnet18_v1",
                                  "llama"])
def test_collect_params_names_match_jax(kind):
    jnet, net = _named_nets(kind)
    jnames, names = list(jnet.collect_params()), list(net.collect_params())
    assert names == jnames
    assert net.prefix == jnet.prefix and net.name == jnet.name
    assert [p.grad_req for p in net.collect_params().values()] == \
        [p.grad_req for p in jnet.collect_params().values()]
    structural = list(net._collect_params_with_prefix())
    assert structural == list(jnet._collect_params_with_prefix())
    if kind in ("bert_small", "llama"):     # no deferred shapes
        assert structural == list(net.state_dict())
    # a second net of the same kind takes the next global name
    jnet2, net2 = _named_nets(kind)
    assert net2.prefix == jnet2.prefix != net.prefix


def test_sharing_through_params_matches_jax():
    for pkg_nn in (jnn, nn):
        a = pkg_nn.Dense(4, in_units=3)
        b = pkg_nn.Dense(4, in_units=3, params=a.collect_params())
        assert list(b.collect_params()) == list(a.collect_params())
        assert b.collect_params()["dense0_weight"] is \
            a.collect_params()["dense0_weight"]
    assert b.weight is a.weight
    a.initialize()
    x = tmx.nd.array(np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(a(x).asnumpy(), b(x).asnumpy())


# -- nd.save / nd.load -----------------------------------------------------------

def _bf16_exact(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["dict", "list"])
def test_nd_save_bytes_match_jax(tmp_path, dtype, form):
    vals = [_bf16_exact((3, 4), 0), _bf16_exact((5,), 1),
            np.arange(6, dtype=np.float32).reshape(2, 3)]
    jarrs = [jnd.array(v, dtype=dtype) for v in vals]
    tarrs = [tmx.nd.array(v, dtype=dtype) for v in vals]
    names = ["w", "layer.bias", "running_mean"]
    jpay = dict(zip(names, jarrs)) if form == "dict" else jarrs
    tpay = dict(zip(names, tarrs)) if form == "dict" else tarrs
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnd.save(jf, jpay)
    tmx.nd.save(tf, tpay)
    with open(jf, "rb") as f1, open(tf, "rb") as f2:
        assert f1.read() == f2.read()
    got, jgot = tmx.nd.load(jf), jnd.load(tf)
    if form == "dict":
        assert list(got) == list(jgot) == names
        got, jgot = list(got.values()), list(jgot.values())
    for g, j, v in zip(got, jgot, vals):
        assert g.dtype == np.float32        # bf16 is written as f32
        np.testing.assert_array_equal(g.asnumpy(), v)
        np.testing.assert_array_equal(np.asarray(j.asnumpy(), np.float32), v)


def test_nd_load_reads_the_npz_form(tmp_path):
    f = str(tmp_path / "old.params")
    with open(f, "wb") as fh:
        np.savez(fh, __kind__=np.array("dict"),
                 **{"key:a": np.ones(3, np.float32),
                    "key:b": np.zeros((2, 2), np.float32)})
    got = tmx.nd.load(f)
    assert sorted(got) == ["a", "b"] and got["a"].shape == (3,)
    single = str(tmp_path / "one.params")
    with open(single, "wb") as fh:
        np.savez(fh, __kind__=np.array("single"), arr_0=np.ones(2))
    assert tmx.nd.load(single).shape == (2,)


# -- save_parameters / load_parameters ------------------------------------------

def _bert_pair():
    jnet = jbert.bert_small()
    jnet.initialize(mx.init.Normal(0.05))
    net = bert.bert_small(device="cpu")
    net.initialize()
    return jnet, net


def _resnet_pair(layout):
    jnet = jvision.resnet18_v1(layout=layout, classes=10, thumbnail=True)
    jnet.initialize(mx.init.Xavier())
    net = vision.resnet18_v1(layout=layout, classes=10, thumbnail=True,
                             device="cpu")
    net.initialize()
    return jnet, net


def _forward_both(kind, jnet, net):
    if kind == "bert_small":
        toks = np.random.RandomState(3).randint(0, 1000, (2, 16))
        jout = jnet(jnd.array(toks, dtype="int32"))[2]
        out = net(tmx.nd.array(toks, dtype="int32"))[2]
    else:
        x = np.random.RandomState(3).randn(2, 3, 16, 16).astype(np.float32)
        jout, out = jnet(jnd.array(x)), net(tmx.nd.array(x))
    return jout.asnumpy(), out.asnumpy()


@pytest.mark.parametrize("kind", ["bert_small", "resnet18_v1-NCHW",
                                  "resnet18_v1-NHWC"])
def test_params_files_cross_both_ways(tmp_path, kind):
    name, _, layout = kind.partition("-")
    jnet, net = _bert_pair() if name == "bert_small" \
        else _resnet_pair(layout)
    _forward_both(name, jnet, net)          # the JAX side's deferred shapes
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.save_parameters(jf)
    net.load_parameters(jf)
    jout, out = _forward_both(name, jnet, net)
    _close(out, jout)
    # the other way: a freshly initialized port net into a fresh JAX net
    net2 = bert.bert_small(device="cpu") if name == "bert_small" else \
        vision.resnet18_v1(layout=layout, classes=10, thumbnail=True,
                           device="cpu")
    net2.initialize(tmx.init.Normal(0.05))
    _forward_both(name, jnet, net2)         # the port side's deferred shapes
    net2.save_parameters(tf)
    assert list(tmx.nd.load(tf)) == list(jnet._collect_params_with_prefix())
    jnet2 = jbert.bert_small() if name == "bert_small" else \
        jvision.resnet18_v1(layout=layout, classes=10, thumbnail=True)
    jnet2.load_parameters(tf)
    jout, out = _forward_both(name, jnet2, net2)
    _close(out, jout)
    # a file of the same values is written byte for byte the same
    jnet2.save_parameters(jf)
    with open(jf, "rb") as f1, open(tf, "rb") as f2:
        assert f1.read() == f2.read()


def test_load_parameters_fallbacks_match_jax(tmp_path):
    jnet = _mlp(jnn)
    jnet.initialize()
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    want = jnet(jnd.array(x)).asnumpy()
    flat = {p.name: p.data() for p in jnet.collect_params().values()}
    cases = {
        "argaux": {"arg:" + k: v for k, v in flat.items()},
        "flat": flat,
        # a fresh instance's prefix differs: hybridsequential1_...
        "prefix": {k.replace("hybridsequential0", "hybridsequential9"): v
                   for k, v in flat.items()},
    }
    for case, payload in cases.items():
        f = str(tmp_path / (case + ".params"))
        jnd.save(f, payload)
        for loader in (jnn, nn):
            n = _mlp(loader)
            n.load_parameters(f)
            arr = (jnd if loader is jnn else tmx.nd).array(x)
            np.testing.assert_allclose(n(arr).asnumpy(), want, err_msg=case,
                                       **TOL)


def test_load_parameters_missing_and_extra(tmp_path):
    net = nn.Dense(3, in_units=2)
    net.initialize()
    f = str(tmp_path / "p.params")
    net.save_parameters(f)
    bigger = nn.HybridSequential()
    bigger.add(nn.Dense(3, in_units=2), nn.Dense(2, in_units=3))
    with pytest.raises(MXNetError, match="missing"):
        bigger.load_parameters(f)
    tmx.nd.save(f, {"weight": tmx.nd.array(net.weight.detach().numpy()),
                    "bias": tmx.nd.array(net.bias.detach().numpy()),
                    "extra": tmx.nd.zeros((2,))})
    fresh = nn.Dense(3, in_units=2)
    with pytest.raises(MXNetError, match="extra"):
        fresh.load_parameters(f)
    fresh.load_parameters(f, ignore_extra=True)
    np.testing.assert_array_equal(fresh.weight.detach().numpy(),
                                  net.weight.detach().numpy())
    bigger.load_parameters(f, allow_missing=True, ignore_extra=True)


# -- grad_req, lr_mult, wd_mult ----------------------------------------------------

def _dense_pair(seed=0, units=2, in_units=3):
    rs = np.random.RandomState(seed)
    w = rs.randn(units, in_units).astype(np.float32)
    b = rs.randn(units).astype(np.float32)
    jd, td = jnn.Dense(units, in_units=in_units), nn.Dense(units,
                                                          in_units=in_units)
    for d in (jd, td):
        d.initialize()
        weight, bias = d.collect_params().values()
        weight.set_data(w)
        bias.set_data(b)
    return jd, td


def _backward_twice(jd, td, x):
    for _ in range(2):
        with jautograd.record():
            jl = (jd(jnd.array(x)) ** 2).sum()
        jl.backward()
        with tautograd.record():
            tl = (td(tmx.nd.array(x)) ** 2).sum()
        tl.backward()


def test_grad_req_add_accumulates_as_in_jax():
    jd, td = _dense_pair()
    for d in (jd, td):
        d.collect_params().setattr("grad_req", "add")
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    _backward_twice(jd, td, x)
    for jp, tp in zip(jd.collect_params().values(),
                      td.collect_params().values()):
        np.testing.assert_allclose(tp.grad().asnumpy(), jp.grad().asnumpy(),
                                   **GRAD_TOL)
    # a Trainer step keeps an accumulated gradient, as the JAX package's
    before = td.weight.grad.clone()
    for g, d in ((jgluon, jd), (gluon, td)):
        g.Trainer(d.collect_params(), "sgd",
                  {"learning_rate": 0.1}).step(1)
    assert torch.equal(td.weight.grad, before)
    td.zero_grad()
    jd.collect_params().zero_grad()
    assert not td.weight.grad.any() and not td.bias.grad.any()
    # "write" again: the next backward overwrites
    td.collect_params().setattr("grad_req", "write")
    jd.collect_params().setattr("grad_req", "write")
    _backward_twice(jd, td, x)
    np.testing.assert_allclose(
        td.collect_params()["dense0_weight"].grad().asnumpy(),
        jd.weight.grad().asnumpy(), **GRAD_TOL)


def test_grad_req_null_is_left_out_by_trainer_and_jit_step():
    jd, td = _dense_pair()
    for d in (jd, td):
        d.collect_params(".*bias").setattr("grad_req", "null")
    assert not td.bias.requires_grad
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    bias = td.bias.detach().clone()
    jtr = jgluon.Trainer(jd.collect_params(), "sgd", {"learning_rate": 0.1})
    ttr = gluon.Trainer(td.collect_params(), "sgd", {"learning_rate": 0.1})
    for _ in range(2):
        with jautograd.record():
            jl = (jd(jnd.array(x)) ** 2).sum()
        jl.backward()
        jtr.step(2)
        with tautograd.record():
            tl = (td(tmx.nd.array(x)) ** 2).sum()
        tl.backward()
        ttr.step(2)
    assert td.bias.grad is None and torch.equal(td.bias.detach(), bias)
    np.testing.assert_allclose(td.weight.detach().numpy(),
                               jd.weight.data().asnumpy(), **GRAD_TOL)
    step = parallel.JitTrainStep(td, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1})
    step.step(torch.from_numpy(x), torch.tensor([0.0, 1.0]))
    assert [step._names[i] for i in step._train_idx] == ["weight"]
    assert torch.equal(td.bias.detach(), bias)


def _trainer_run(g, nd_mod, rec, net, opt, opt_params, x, y, steps=3):
    net.collect_params(".*bias").setattr("wd_mult", 0.0)
    first = list(net.collect_params().values())[0]
    first.lr_mult = 0.5
    loss_fn = g.loss.SoftmaxCrossEntropyLoss()
    trainer = g.Trainer(net.collect_params(), opt, opt_params)
    for _ in range(steps):
        with rec():
            loss = loss_fn(net(nd_mod.array(x)), nd_mod.array(y))
        loss.backward()
        trainer.step(x.shape[0])
    return [p.data().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_lr_and_wd_mult_match_jax(opt):
    rs = np.random.RandomState(1)
    x = rs.randn(4, 5).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    jnet, net = _mlp(jnn), _mlp(nn)
    jnet.initialize(mx.init.Xavier())
    jnet(jnd.array(x))
    net.initialize()
    net(tmx.nd.array(x))
    for jp, tp in zip(jnet.collect_params().values(),
                      net.collect_params().values()):
        tp.set_data(jp.data().asnumpy())
    params = {"learning_rate": 0.1, "wd": 0.05}
    if opt == "sgd":
        params["momentum"] = 0.9
    jw = _trainer_run(jgluon, jnd, jautograd.record, jnet, opt, params, x, y)
    tw = _trainer_run(gluon, tmx.nd, tautograd.record, net, opt, params, x, y)
    for a, b in zip(tw, jw):
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)


# -- hooks, apply, summary, infer_shape ---------------------------------------------

def test_forward_hooks_and_apply_match_jax():
    x = np.ones((2, 4), np.float32)
    seen = {}
    for tag, pkg_nn, nd_mod in (("jax", jnn, jnd), ("port", nn, tmx.nd)):
        net = _mlp(pkg_nn)
        net.initialize()
        calls = []
        pre = net.register_forward_pre_hook(
            lambda b, ins: calls.append(("pre", b.name, ins[0].shape)))
        post = net[0].register_forward_hook(
            lambda b, ins, out: calls.append(("post", b.name, out.shape)))
        net(nd_mod.array(x))
        pre.detach()
        with post:
            net(nd_mod.array(x))
        net(nd_mod.array(x))
        names = []
        net.apply(lambda b: names.append(b.name))
        seen[tag] = (calls, names)
    assert seen["port"] == seen["jax"]


def test_summary_prints_the_jax_rows(capsys):
    x = np.ones((2, 4), np.float32)
    out = {}
    for tag, pkg_nn, nd_mod in (("jax", jnn, jnd), ("port", nn, tmx.nd)):
        net = _mlp(pkg_nn)
        net.initialize()
        net(nd_mod.array(x))
        capsys.readouterr()
        net.summary(nd_mod.array(x))
        out[tag] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "Total params: 67" in out["port"]


def test_infer_shape_matches_jax():
    x = np.ones((2, 3, 6, 6), np.float32)
    for g, pkg_nn, nd_mod in ((jgluon, jnn, jnd), (gluon, nn, tmx.nd)):
        dense, conv = pkg_nn.Dense(5), pkg_nn.Conv2D(4, 3, layout="NCHW")
        bn, ln = pkg_nn.BatchNorm(axis=1), pkg_nn.LayerNorm()
        for b in (dense, conv, bn, ln):
            b.initialize()
            b.infer_shape(nd_mod.array(x))
        assert dense.collect_params()["dense0_weight"].shape == (5, 108)
        assert conv.collect_params()["conv2d0_weight"].shape == (4, 3, 3, 3)
        assert bn.collect_params()["batchnorm0_running_var"].shape == (3,)
        assert ln.collect_params()["layernorm0_gamma"].shape == (6,)
        with pytest.raises(g.DeferredInitializationError):
            dense.collect_params()["dense0_weight"].data()
        assert dense(nd_mod.array(x)).shape == (2, 5)


# -- NDArrays through blocks ---------------------------------------------------------

def test_ndarray_through_blocks_records_and_returns_ndarrays():
    net = _mlp(nn)
    net.initialize()
    x = tmx.nd.array(np.ones((2, 4), np.float32))
    x.attach_grad()
    with tautograd.record():
        y = net(x)
        loss = (y * y).sum()
    assert isinstance(y, tmx.nd.NDArray) and y.context == CPU
    loss.backward()
    assert x.grad is not None and x.grad.asnumpy().any()
    w = net.collect_params()["hybridsequential0_dense0_weight"]
    assert w.grad().asnumpy().any() and w._tensor._fresh_grad
    # tensors in, tensors out; hybridized NDArray calls as well
    assert isinstance(net(torch.ones(2, 4)), torch.Tensor)
    net.hybridize()
    np.testing.assert_array_equal(net(x).asnumpy(), y.asnumpy())
    # a lazy array from a bulk segment is flushed before the block reads it
    lazy = tmx.nd.ones((2, 4)) * 1.0
    np.testing.assert_array_equal(net(lazy).asnumpy(), y.asnumpy())


# -- gluon.utils ----------------------------------------------------------------------

def test_clip_global_norm_matches_jax():
    rs = np.random.RandomState(2)
    vals = [rs.randn(3, 4).astype(np.float32) * 3, rs.randn(5).astype(
        np.float32)]
    jarrs = [jnd.array(v) for v in vals]
    tarrs = [tmx.nd.array(v) for v in vals]
    jn = jgluon.utils.clip_global_norm(jarrs, 1.0)
    tn = gluon.utils.clip_global_norm(tarrs, 1.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(tarrs, jarrs):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    nd_norm = gluon.utils.clip_global_norm(tarrs, 10.0, check_isfinite=False)
    assert nd_norm.shape == (1,)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        gluon.utils.clip_global_norm([tmx.nd.array([np.inf, 1.0])], 1.0)
    assert any("nan or inf" in str(m.message) for m in w)


def test_split_and_load_and_files(tmp_path):
    x = np.arange(20, dtype=np.float32).reshape(5, 4)
    for j, t in zip(jgluon.utils.split_data(jnd.array(x), 2,
                                            even_split=False),
                    gluon.utils.split_data(tmx.nd.array(x), 2,
                                           even_split=False)):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    with pytest.raises(ValueError):
        gluon.utils.split_data(tmx.nd.array(x), 2)
    (one,) = gluon.utils.split_and_load(x, [CPU])
    np.testing.assert_array_equal(one.asnumpy(), x)
    f = tmp_path / "blob.bin"
    f.write_bytes(b"mxnet")
    sha = hashlib.sha1(b"mxnet").hexdigest()
    assert gluon.utils.check_sha1(str(f), sha)
    assert gluon.utils.download("http://host/blob.bin", path=str(tmp_path),
                                sha1_hash=sha) == str(f)
    with pytest.raises(MXNetError, match="local files only"):
        gluon.utils.download("http://host/other.bin", path=str(tmp_path))
    with pytest.raises(MXNetError, match="local files only"):
        gluon.utils.download("http://host/blob.bin", path=str(tmp_path),
                             sha1_hash="0" * 40)
    assert gluon.utils.shape_is_known((2, 3)) and \
        not gluon.utils.shape_is_known((2, 0))


# -- a train_mnist.py-shaped loop ------------------------------------------------------

def _mnist_loop(g, nd_mod, rec, metric_mod, net, x, y, batch):
    trainer = g.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = g.loss.SoftmaxCrossEntropyLoss()
    metric = metric_mod.Accuracy()
    losses = []
    for i in range(0, len(x), batch):
        data = nd_mod.array(x[i:i + batch])
        label = nd_mod.array(y[i:i + batch])
        with rec():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(data.shape[0])
        metric.update(label, out)
        losses.append(loss.asnumpy())
    return losses, metric.get()


def test_train_mnist_shaped_loop_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    protos = rs.rand(10, 1, 8, 8).astype(np.float32)
    y = rs.randint(0, 10, 48)
    x = (protos[y] + 0.1 * rs.randn(48, 1, 8, 8)).astype(np.float32)
    y = y.astype(np.float32)

    def build(pkg_nn):
        net = pkg_nn.HybridSequential()
        net.add(pkg_nn.Flatten(), pkg_nn.Dense(32, activation="tanh"),
                pkg_nn.Dense(10))
        return net
    jnet, net = build(jnn), build(nn)
    jnet.initialize(mx.init.Xavier())
    jnet(jnd.array(x[:2]))
    f = str(tmp_path / "init.params")
    jnet.save_parameters(f)
    net.load_parameters(f)
    jnet.hybridize()
    net.hybridize()
    jl, jm = _mnist_loop(jgluon, jnd, jautograd.record, mx.metric, jnet, x,
                         y, 16)
    tl, tm = _mnist_loop(gluon, tmx.nd, tautograd.record, tmx.metric, net,
                         x, y, 16)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    assert tm == jm


def test_jit_train_step_runs_a_hybridized_net_inline():
    """A ``JitTrainStep`` over a hybridized net whose graph pair exists
    (the pair's card-free double, as ``test_torch_graphs.py`` reaches
    it) runs the net eagerly inside its step: the net's own graphs are
    not called (on the card a captured step replaying them failed), and
    the step's losses equal those over the same net not hybridized."""
    x = np.random.RandomState(4).randn(4, 5).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    losses = []
    for hybrid in (False, True):
        net = _mlp(nn)
        net.initialize(tmx.init.Xavier(),
                       generator=torch.Generator().manual_seed(0))
        if hybrid:
            net.hybridize()
            net._graphs.pairs_on = lambda device: True
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.0})
            for _ in range(3):          # the pair's eager call, capture, replay
                with tautograd.record():
                    loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                        net(tmx.nd.array(x)), tmx.nd.array(y))
                loss.backward()
                trainer.step(4)
            before = net.stats()
            assert before["captures"] == 1
        step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                     "sgd", {"learning_rate": 0.1})
        losses.append([float(step.step(torch.from_numpy(x),
                                       torch.from_numpy(y)))
                       for _ in range(3)])
        if hybrid:
            assert net.stats() == before
    assert losses[1] == losses[0]


@pytest.mark.parametrize("kw", [dict(axis=-1), dict(axis=1, temperature=2.0),
                                dict(axis=-1, use_length=True)])
@pytest.mark.parametrize("op", ["softmax", "log_softmax"])
def test_softmax_ops_match_jax(op, kw):
    """``nd.softmax``/``nd.log_softmax`` (the metric path's
    probabilities) against the JAX package's ops."""
    if op == "log_softmax" and kw.get("use_length"):
        kw = dict(axis=0)
    x = np.random.RandomState(5).randn(3, 4, 6).astype(np.float32)
    args = [x]
    if kw.get("use_length"):
        args.append(np.array([2, 6, 4], np.float32))
    jout = getattr(jnd, op)(*[jnd.array(a) for a in args], **kw)
    tout = getattr(tmx.nd, op)(*[tmx.nd.array(a) for a in args], **kw)
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    if op == "softmax" and not kw.get("use_length"):
        np.testing.assert_allclose(
            tmx.nd.array(x).softmax(**kw).asnumpy(), jout.asnumpy(), **TOL)


def test_standalone_parameter_through_nd_ops_and_trainer_matches_jax():
    """A Parameter no block owns, used through ``data()`` in NDArray ops
    under ``record()`` and stepped by a Trainer: each backward writes its
    gradient (two backward passes leave one's), as in the JAX package."""
    x = np.arange(3, dtype=np.float32) + 1.0
    out = {}
    for tag, g, nd_mod, rec in (("jax", jgluon, jnd, jautograd.record),
                                ("port", gluon, tmx.nd, tautograd.record)):
        w = g.Parameter("w", shape=(3,))
        w.initialize(init=mx.init.One() if tag == "jax"
                     else tmx.init.One())
        trainer = g.Trainer([w], "sgd", {"learning_rate": 0.1})
        grads = []
        for _ in range(2):
            for _ in range(2):
                with rec():
                    loss = (w.data() * nd_mod.array(x) * w.data()).sum()
                loss.backward()
            grads.append(w.grad().asnumpy().copy())
            trainer.step(1)
        out[tag] = (grads, w.data().asnumpy())
    for a, b in zip(out["port"][0], out["jax"][0]):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], **GRAD_TOL)
