"""The recurrent slice against the JAX package on the CPU: the ``RNN`` op
(``nd.RNN``/``nd.rnn``) and ``gluon.rnn``'s fused layers
(``test_torch_rnn_cells.py`` holds the cells, ``gluon.contrib.rnn``,
``npx.rnn`` and upstream's word language model).

The same seeded numpy inputs go through both packages, with the JAX
layer's or cell's weights copied into the port's by name
(:func:`copy_params`).  Tolerances: f32 outputs and states rtol 1e-5 /
atol 1e-6; gradients against ``jax.vjp`` (or the JAX package's
autograd) rtol 1e-4 / atol 1e-5; bf16 2e-2 (relative, and absolute on
the output's scale).  Random draws (dropout,
zoneout, the variational masks) differ between the packages by design:
they are compared in predict mode for values and checked in train mode
for shapes, masks and moments.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu.ndarray  # noqa: F401  (registers the JAX package's ops)
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as treg

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
MODES = ("rnn_tanh", "rnn_relu", "lstm", "gru")
T, B, I, H = 5, 3, 4, 6


def copy_params(jblock, tblock):
    """Copy a JAX block's parameters into the port's by structural name,
    as numpy arrays (both must have their shapes: run a forward of each
    first where shapes are deferred)."""
    src = {k: np.array(p.data().asnumpy())
           for k, p in jblock._collect_params_with_prefix().items()}
    dst = tblock._collect_params_with_prefix()
    assert sorted(src) == sorted(dst)
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(torch.from_numpy(src[k]))


def _rs(seed):
    return np.random.RandomState(seed)


def _close(got, want, tol=FWD):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **tol)


# -- the op ------------------------------------------------------------------


def _op_inputs(mode, layers, bi, given, seed=0):
    rs = _rs(seed)
    dirs = 2 if bi else 1
    n = tnn.rnn_param_size(mode, layers, I, H, bi)
    x = rs.standard_normal((T, B, I)).astype(np.float32)
    p = (rs.standard_normal(n) * 0.4).astype(np.float32)
    h0 = rs.standard_normal((layers * dirs, B, H)).astype(np.float32)
    ins = [x, p, h0 if given else np.zeros_like(h0)]
    if given and mode == "lstm":
        ins.append(rs.standard_normal(h0.shape).astype(np.float32))
    attrs = dict(state_size=H, num_layers=layers, mode=mode,
                 bidirectional=bi)
    return ins, attrs


def _port_run(fn, ins, heads):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in ins]
    outs = fn(*ts)
    used = [(o, torch.from_numpy(h)) for o, h in zip(outs, heads)
            if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in used], ts,
                                [h for _, h in used], allow_unused=True)
    return [o.detach().numpy() for o in outs], grads


@pytest.mark.parametrize("given", [False, True], ids=["zero_states",
                                                     "given_states"])
@pytest.mark.parametrize("layers,bi", [(1, False), (2, True)],
                         ids=["1_layer", "2_layers_bi"])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_fused_and_plain_match_jax(mode, layers, bi, given):
    """``RNN``'s fused route and ``_rnn_plain`` against the JAX op:
    (out, h_n, c_n) and the gradients of data, parameters and states
    (``jax.vjp`` with the same seeded heads)."""
    ins, attrs = _op_inputs(mode, layers, bi, given)
    jfwd = jreg.get("RNN").forward
    want, vjp = jax.vjp(
        lambda *a: jfwd(jax.random.PRNGKey(0), *a, **attrs),
        *[jnp.asarray(a) for a in ins])
    heads = [_rs(7 + k).standard_normal(np.asarray(w).shape)
             .astype(np.float32) for k, w in enumerate(want)]
    want_g = vjp(tuple(jnp.asarray(h) for h in heads))

    def plain(*ts):
        layers_w = tnn._unpack_rnn_params(ts[1], mode, layers, I, H, bi)
        return tnn._rnn_plain(ts[0], layers_w, ts[2],
                              ts[3] if len(ts) > 3 else None,
                              num_layers=layers, mode=mode,
                              bidirectional=bi)

    for fn in (lambda *ts: treg.get("RNN").forward(*ts, **attrs), plain):
        got, got_g = _port_run(fn, ins, heads)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **FWD)
        for g, w in zip(got_g, want_g):
            g = np.zeros_like(np.asarray(w)) if g is None else g.numpy()
            np.testing.assert_allclose(g, np.asarray(w), **GRAD)


def test_rnn_param_size_and_the_alias_match_jax():
    from mxnet_tpu.ops.nn import rnn_param_size as jsize

    for mode in MODES:
        for layers, bi in ((1, False), (3, True)):
            for i in (4, 7):
                assert tnn.rnn_param_size(mode, layers, i, 5, bi) \
                    == jsize(mode, layers, i, 5, bi)
    assert treg.get("rnn") is treg.get("RNN")
    ins, attrs = _op_inputs("gru", 1, False, True)
    with tmx.cpu():
        got = tmx.nd.rnn(*[tmx.nd.array(a) for a in ins], **attrs)
    want = jmx.nd.rnn(*[jmx.nd.array(a) for a in ins], **attrs)
    _close(list(got), list(want))


def test_rnn_op_under_amp_runs_in_bf16_as_jax():
    """Under AMP bf16 (``RNN`` is on the target-dtype list) both packages
    compute the op in bf16; the results agree within 2e-2 of the largest
    value (the two round at other places, and a relu stack's values reach
    about 3)."""
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch import amp as tamp

    jamp.init("bfloat16")
    tamp.init("bfloat16")
    try:
        for mode in MODES:
            ins, attrs = _op_inputs(mode, 2, True, True, seed=3)
            with tmx.cpu():
                got = tmx.nd.RNN(*[tmx.nd.array(a) for a in ins], **attrs)
            want = jmx.nd.RNN(*[jmx.nd.array(a) for a in ins], **attrs)
            for g, w in zip(got, want):
                assert g.data().dtype == torch.bfloat16
                assert str(w.dtype) == "bfloat16"
                w = w.asnumpy().astype(np.float32)
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(
                    g.asnumpy().astype(np.float32), w,
                    rtol=BF16["rtol"], atol=BF16["atol"] * scale)
    finally:
        jamp.turn_off()
        tamp.turn_off()


def test_rnn_op_dropout_between_layers_by_moments(monkeypatch):
    """Train mode with ``p`` > 0: the fused function runs once a layer and
    the port's ``Dropout`` drops each layer's output but the last,
    keeping ``1 - p`` of it scaled by ``1 / (1 - p)``; in predict mode
    one call runs the stack and nothing is dropped."""
    p, layers = 0.4, 3
    seen, calls = [], []
    dropout, stack = tnn._dropout, tnn._fused_stack

    def spy_dropout(x, **kw):
        out = dropout(x, **kw)
        seen.append((x.detach(), out.detach()))
        return out

    def spy_stack(*a, **kw):
        calls.append(1)
        return stack(*a, **kw)

    monkeypatch.setattr(tnn, "_dropout", spy_dropout)
    monkeypatch.setattr(tnn, "_fused_stack", spy_stack)
    rs = _rs(5)
    t, b, i, h = 20, 16, 8, 32
    n = tnn.rnn_param_size("lstm", layers, i, h, True)
    ins = [rs.standard_normal((t, b, i)).astype(np.float32),
           (rs.standard_normal(n) * 0.3).astype(np.float32),
           np.zeros((2 * layers, b, h), np.float32)]
    attrs = dict(state_size=h, num_layers=layers, mode="lstm",
                 bidirectional=True, p=p)
    with tmx.cpu():
        args = [tmx.nd.array(a) for a in ins]
        with tmx.autograd.train_mode():
            out = tmx.nd.RNN(*args, **attrs)[0]
        assert out.shape == (t, b, 2 * h)
        assert len(calls) == layers and len(seen) == layers - 1
        zeros = kept = total = 0
        for x, y in seen:
            drop = y == 0
            zeros += int(drop.sum())
            total += y.numel()
            torch.testing.assert_close(y[~drop], x[~drop] / (1 - p),
                                       rtol=1e-6, atol=0)
            kept += int((~drop).sum())
        assert abs(zeros / total - p) < 0.02, zeros / total
        seen.clear()
        calls.clear()
        with tmx.autograd.predict_mode():
            tmx.nd.RNN(*args, **attrs)
        assert len(calls) == 1 and not seen


# -- the fused layers ----------------------------------------------------------


def _layer_pair(cls, layout="TNC", **kw):
    jl = getattr(jrnn, cls)(H, layout=layout, **kw)
    jl.initialize()
    with tmx.cpu():
        tl = getattr(trnn, cls)(H, layout=layout, **kw)
        tl.initialize()
    return jl, tl


def _seq(layout, seed=1, i=I):
    shape = (T, B, i) if layout == "TNC" else (B, T, i)
    return _rs(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("cls,kw", [
    ("LSTM", dict(num_layers=2, bidirectional=True)),
    ("GRU", dict(num_layers=2)),
    ("RNN", dict(activation="tanh", bidirectional=True)),
    ("RNN", dict(num_layers=2))], ids=["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_layers_match_jax_in_both_layouts(cls, kw, layout):
    """Deferred ``input_size``, the output without states, and with
    ``begin_state``'s and given states the output and new states."""
    jl, tl = _layer_pair(cls, layout, **kw)
    x = _seq(layout)
    jl(jmx.nd.array(x))
    with tmx.cpu():
        tl(tmx.nd.array(x))
        copy_params(jl, tl)
        got = tl(tmx.nd.array(x))
        got_s = tl(tmx.nd.array(x), tl.begin_state(B))
        h = _rs(2).standard_normal(got_s[1][0].shape).astype(np.float32)
        given = [tmx.nd.array(h)] * len(got_s[1])
        got_g = tl(tmx.nd.array(x), given)
    _close(got, jl(jmx.nd.array(x)))
    want_s = jl(jmx.nd.array(x), jl.begin_state(B))
    _close([got_s[0]] + got_s[1], [want_s[0]] + want_s[1])
    want_g = jl(jmx.nd.array(x), [jmx.nd.array(h)] * len(got_s[1]))
    _close([got_g[0]] + got_g[1], [want_g[0]] + want_g[1])
    assert [p for p in tl.collect_params()] \
        == [p for p in jl.collect_params()]
    assert repr(tl) == repr(jl)


def test_lstm_layer_gradients_match_jax():
    jl, tl = _layer_pair("LSTM", num_layers=2, bidirectional=True,
                         input_size=I)
    x = _seq("TNC")
    with tmx.cpu():
        copy_params(jl, tl)
    grads = []
    for mx, layer in ((jmx, jl), (tmx, tl)):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            xa = mx.nd.array(x)
            xa.attach_grad()
            with mx.autograd.record():
                out, st = layer(xa, layer.begin_state(B))
                loss = (out * out).sum() + (st[1] * st[0]).sum()
            loss.backward()
            grads.append([xa.grad.asnumpy()]
                         + [p.grad().asnumpy()
                            for p in layer.collect_params().values()])
    for g, w in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g, w, **GRAD)


def test_layer_equals_the_op_on_its_packed_vector():
    """The layer hands its parameters to the op's function as they are;
    ``nd.RNN`` on the packed vector (``_ordered_param_names``, the JAX
    package's concatenation) gives the same output and states."""
    with tmx.cpu():
        layer = trnn.LSTM(H, num_layers=2, bidirectional=True, input_size=I)
        layer.initialize()
        x = tmx.nd.array(_seq("TNC"))
        states = layer.begin_state(B)
        out, new = layer(x, states)
        handles = layer._reg_params
        packed = tmx.nd.concat(*[
            tmx.nd.array(handles[n].data().asnumpy().reshape(-1))
            for n in layer._ordered_param_names()], dim=0)
        want = tmx.nd.RNN(x, packed, *states, state_size=H, num_layers=2,
                          mode="lstm", bidirectional=True)
    _close([out] + new, list(want))


def test_hybridized_layer_and_unroll_match_jax():
    """A hybridized LSTM (on the host the calls run eagerly; on the card
    they are graphs, ``test_torch_kernels_cuda.py``) and the layer's
    ``unroll`` with ``valid_length``, merged and split."""
    jl, tl = _layer_pair("LSTM", "NTC", num_layers=1, input_size=I)
    x = _seq("NTC")
    vl = np.array([5, 2, 3], np.float32)
    with tmx.cpu():
        copy_params(jl, tl)
        tl.hybridize()
        got = [tl(tmx.nd.array(x)) for _ in range(3)]
        assert tl.stats()["captures"] == 0
        got_u = tl.unroll(T, tmx.nd.array(x), layout="NTC",
                          merge_outputs=True, valid_length=tmx.nd.array(vl))
        got_s = tl.unroll(T, tmx.nd.array(x), layout="NTC",
                          merge_outputs=False)
    jl.hybridize()
    want = jl(jmx.nd.array(x))
    for g in got:
        _close(g, want)
    want_u = jl.unroll(T, jmx.nd.array(x), layout="NTC", merge_outputs=True,
                       valid_length=jmx.nd.array(vl))
    _close([got_u[0]] + got_u[1], [want_u[0]] + want_u[1])
    want_s = jl.unroll(T, jmx.nd.array(x), layout="NTC",
                       merge_outputs=False)
    _close(list(got_s[0]) + got_s[1], list(want_s[0]) + want_s[1])


def test_layer_params_files_load_across_the_packages(tmp_path):
    jl, tl = _layer_pair("GRU", num_layers=2, bidirectional=True,
                         input_size=I)
    x = _seq("TNC")
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jl.save_parameters(jf)
    with tmx.cpu():
        tl.load_parameters(jf)
        got = tl(tmx.nd.array(x))
        other = trnn.GRU(H, num_layers=2, bidirectional=True, input_size=I)
        other.initialize()
        other.save_parameters(tf)
        got_other = other(tmx.nd.array(x))
    _close(got, jl(jmx.nd.array(x)))
    jl.load_parameters(tf)
    _close(got_other, jl(jmx.nd.array(x)))


def test_projection_size_raises_as_jax():
    with pytest.raises(MXNetError, match="projection_size"):
        trnn.LSTM(H, projection_size=3)
