"""The port's ``mx.metric`` against the JAX package's, on the CPU: every
metric class updated with the same predictions and labels (the port's
as NDArrays and as torch tensors), ``get``/``get_name_value``/
``get_global``/``reset``/``reset_local``, the composite metric, and
construction through ``create`` by name, alias, list and callable.

Predictions and labels come from numpy seeds.  Tolerance: counts and
names exact; float values rtol 1e-6 (the device-side sums of
``Accuracy``, ``Loss`` and ``Perplexity`` add in another order than
numpy's).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as tmx

RTOL = 1e-6
CPU = tmx.cpu()


def _data(seed=0, n=12, classes=4):
    rs = np.random.RandomState(seed)
    logits = rs.randn(n, classes).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rs.randint(0, classes, n).astype(np.float32)
    return probs.astype(np.float32), labels


def _binary(seed=0, n=16):
    rs = np.random.RandomState(seed)
    p = rs.rand(n).astype(np.float32)
    probs = np.stack([1 - p, p], 1)
    labels = rs.randint(0, 2, n).astype(np.float32)
    return probs, labels


def _regression(seed=0, n=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 1).astype(np.float32),
            rs.randn(n, 1).astype(np.float32))


CASES = {
    "acc": (lambda m: m.Accuracy(), _data),
    "top_k_accuracy": (lambda m: m.TopKAccuracy(top_k=2), _data),
    "f1": (lambda m: m.F1(), _binary),
    "f1-micro": (lambda m: m.F1(average="micro"), _binary),
    "mcc": (lambda m: m.MCC(), _binary),
    "perplexity": (lambda m: m.Perplexity(None), _data),
    "perplexity-ignore": (lambda m: m.Perplexity(ignore_label=1), _data),
    "mae": (lambda m: m.MAE(), _regression),
    "mse": (lambda m: m.MSE(), _regression),
    "rmse": (lambda m: m.RMSE(), _regression),
    "ce": (lambda m: m.CrossEntropy(), _data),
    "nll_loss": (lambda m: m.NegativeLogLikelihood(), _data),
    "pearsonr": (lambda m: m.PearsonCorrelation(), _regression),
    "pcc": (lambda m: m.PCC(), _data),
    "loss": (lambda m: m.Loss(), lambda seed: tuple(
        np.abs(a) for a in _regression(seed))),     # losses are >= 0
    "custom": (lambda m: m.np(lambda label, pred: float(
        np.abs(label.reshape(-1) - pred.reshape(-1)).mean())), _regression),
}


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("form", ["ndarray", "tensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case, form):
    make, data = CASES[case]
    jm, tm = make(mx.metric), make(tmx.metric)
    assert tm.name == jm.name
    for seed in range(3):
        preds, labels = data(seed)
        if case == "loss":
            jm.update(None, jnd.array(preds))
            port = tmx.nd.array(preds, ctx=CPU) if form == "ndarray" \
                else torch.from_numpy(preds)
            tm.update(None, port)
            continue
        jm.update([jnd.array(labels)], [jnd.array(preds)])
        if form == "ndarray":
            tm.update([tmx.nd.array(labels, ctx=CPU)],
                      [tmx.nd.array(preds, ctx=CPU)])
        else:
            tm.update([torch.from_numpy(labels)], [torch.from_numpy(preds)])
        if seed == 1:
            _same(tm.get(), jm.get())
            jm.reset_local()
            tm.reset_local()
    _same(tm.get(), jm.get())
    _same(tm.get_global(), jm.get_global())
    _same(tm.get_name_value(), jm.get_name_value())
    jm.reset()
    tm.reset()
    _same(tm.get(), jm.get()) if case != "custom" else None
    assert np.isnan(tm.get()[1]) == np.isnan(jm.get()[1])


def test_accuracy_takes_bf16_and_mixed_devices():
    preds, labels = _data(1)
    jm, tm = mx.metric.Accuracy(), tmx.metric.Accuracy()
    jm.update([jnd.array(labels)], [jnd.array(preds)])
    tm.update([tmx.nd.array(labels, ctx=CPU)],
              [tmx.nd.array(preds, ctx=CPU, dtype="bfloat16")])
    assert tm.get() == jm.get()
    assert tmx.metric._as_numpy(
        tmx.nd.array(preds, ctx=CPU, dtype="bfloat16")).dtype == np.float32


def test_composite_and_create_match_jax():
    preds, labels = _data(2)
    for spec in ("acc", "accuracy", ["acc", "perplexity"], "composite",
                 ["acc", "loss"]):
        jm, tm = mx.metric.create(spec), tmx.metric.create(spec)
        assert type(tm).__name__ == type(jm).__name__
        if isinstance(spec, list):
            jm.update([jnd.array(labels)], [jnd.array(preds)])
            tm.update([tmx.nd.array(labels, ctx=CPU)],
                      [tmx.nd.array(preds, ctx=CPU)])
            _same(tm.get(), jm.get())
            _same(tm.get_name_value(), jm.get_name_value())
    comp = tmx.metric.CompositeEvalMetric(["acc", "mae"])
    assert comp.get_metric(0).name == "accuracy"
    feval = lambda label, pred: float((label == pred.argmax(1)).mean())
    jm, tm = mx.metric.create(feval), tmx.metric.create(feval)
    jm.update([jnd.array(labels)], [jnd.array(preds)])
    tm.update([tmx.nd.array(labels, ctx=CPU)],
              [tmx.nd.array(preds, ctx=CPU)])
    _same(tm.get(), jm.get())
    with pytest.raises(Exception):
        tmx.metric.create("no_such_metric")
    assert tmx.metric.get("mse").name == mx.metric.get("mse").name


def test_registry_and_name_are_the_jax_packages():
    from mxnet_tpu_torch import name as tname, registry as treg
    from mxnet_tpu import name as jname, registry as jreg

    assert sorted(n for n in dir(treg) if not n.startswith("_")) == \
        sorted(n for n in dir(jreg) if not n.startswith("_"))
    for mod in (jname, tname):
        with mod.Prefix("mynet_"):
            assert mod.NameManager.current().get(None, "conv") == \
                "mynet_conv0"
            assert mod.NameManager.current().get("fc", "fc") == "mynet_fc"
