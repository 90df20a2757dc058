"""``gluon.rnn``'s cells and modifiers, ``gluon.contrib.rnn``,
``npx.rnn`` and upstream's word language model against the JAX package
on the CPU (the op and the fused layers are in ``test_torch_rnn.py``,
whose :func:`copy_params` and tolerances this file shares).

Random draws (dropout, zoneout, the variational masks) differ between
the packages by design: they are compared in predict mode for values
and checked in train mode for shapes, masks and moments.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.ndarray  # noqa: F401  (registers the JAX package's ops)
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.contrib import rnn as jcrnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn

from test_torch_rnn import (B, GRAD, H, I, T, _close, _op_inputs, _rs, _seq,
                            copy_params)


# -- the cells -------------------------------------------------------------------


def _seq_cell(pkg):
    c = pkg.SequentialRNNCell()
    c.add(pkg.LSTMCell(H))
    c.add(pkg.DropoutCell(0.5))
    c.add(pkg.GRUCell(H))
    return c


def _hseq_cell(pkg):
    c = pkg.HybridSequentialRNNCell()
    c.add(pkg.RNNCell(H, activation="relu"))
    c.add(pkg.LSTMCell(H))
    return c


CELLS = {
    "rnn": lambda m, c: m.RNNCell(H),
    "lstm": lambda m, c: m.LSTMCell(H),
    "gru": lambda m, c: m.GRUCell(H),
    "sequential": lambda m, c: _seq_cell(m),
    "hybrid_sequential": lambda m, c: _hseq_cell(m),
    "dropout": lambda m, c: m.DropoutCell(0.5),
    "zoneout": lambda m, c: m.ZoneoutCell(m.LSTMCell(H), 0.3, 0.3),
    "residual": lambda m, c: m.ResidualCell(m.GRUCell(I)),
    "bidirectional": lambda m, c: m.BidirectionalCell(m.LSTMCell(H),
                                                      m.GRUCell(H)),
    "variational": lambda m, c: c.VariationalDropoutCell(m.LSTMCell(H), 0.3,
                                                         0.3, 0.3),
    "lstmp": lambda m, c: c.LSTMPCell(H, 3),
}


def _cell_pair(name):
    jc = CELLS[name](jrnn, jcrnn)
    jc.initialize()
    with tmx.cpu():
        tc = CELLS[name](trnn, tcrnn)
        tc.initialize()
    return jc, tc


def _unroll_both(jc, tc, x, **kw):
    tkw = dict(kw)
    if "valid_length" in kw:
        with tmx.cpu():
            tkw["valid_length"] = tmx.nd.array(kw["valid_length"])
        kw = dict(kw, valid_length=jmx.nd.array(kw["valid_length"]))
    want = jc.unroll(T, jmx.nd.array(x), **kw)
    with tmx.cpu():
        tc.unroll(T, tmx.nd.array(x), **tkw)     # deferred shapes
        copy_params(jc, tc)
        got = tc.unroll(T, tmx.nd.array(x), **tkw)
    return got, want


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cells_unroll_as_jax_in_predict_mode(name, merge):
    """Every cell and modifier unrolled over NTC steps, merged or split,
    from its ``begin_state``: outputs and final states."""
    jc, tc = _cell_pair(name)
    x = _seq("NTC", seed=3)
    got, want = _unroll_both(jc, tc, x, layout="NTC", merge_outputs=merge)
    out = list(got[0]) if not merge else [got[0]]
    wout = list(want[0]) if not merge else [want[0]]
    _close(out + list(got[1]), wout + list(want[1]))


@pytest.mark.parametrize("name", ["lstm", "sequential", "bidirectional",
                                  "residual"])
def test_cells_unroll_with_valid_length_as_jax(name):
    jc, tc = _cell_pair(name)
    x = _seq("TNC", seed=4)
    got, want = _unroll_both(jc, tc, x, layout="TNC", merge_outputs=True,
                             valid_length=np.array([5, 2, 3], np.float32))
    _close([got[0]] + list(got[1]), [want[0]] + list(want[1]))


@pytest.mark.parametrize("kind,dims", [("RNN", 1), ("LSTM", 2), ("GRU", 3)])
def test_conv_cells_unroll_as_jax(kind, dims):
    shape = (3,) + (5,) * dims
    cls = "Conv%dD%sCell" % (dims, kind)
    jc = getattr(jcrnn, cls)(shape, 4, 3, 3, i2h_pad=1)
    jc.initialize()
    with tmx.cpu():
        tc = getattr(tcrnn, cls)(shape, 4, 3, 3, i2h_pad=1)
        tc.initialize()
    x = _rs(6).standard_normal((2, 3) + shape).astype(np.float32)
    want = jc.unroll(3, jmx.nd.array(x), merge_outputs=True)
    with tmx.cpu():
        copy_params(jc, tc)
        got = tc.unroll(3, tmx.nd.array(x), merge_outputs=True)
    _close([got[0]] + list(got[1]), [want[0]] + list(want[1]),
           dict(rtol=1e-5, atol=1e-5))


def test_cell_steps_and_hybridized_cells_match_jax():
    """A cell stepped by hand (``cell(x_t, states)``) and, hybridized,
    its steps under ``record()`` with a backward: the same outputs and
    the same parameter gradients as the JAX package's."""
    jc, tc = _cell_pair("lstm")
    x = _seq("TNC", seed=8)
    res = []
    for mx, cell in ((jmx, jc), (tmx, tc)):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            if mx is tmx:
                cell(mx.nd.array(x[0]), cell.begin_state(B))
                copy_params(jc, tc)
            cell.hybridize()
            states = cell.begin_state(B)
            with mx.autograd.record():
                outs = []
                for t in range(T):
                    out, states = cell(mx.nd.array(x[t]), states)
                    outs.append(out)
                loss = sum((o * o).sum() for o in outs)
            loss.backward()
            res.append([o.asnumpy() for o in outs]
                       + [p.grad().asnumpy()
                          for p in cell.collect_params().values()])
    for g, w in zip(res[1], res[0]):
        np.testing.assert_allclose(g, w, **GRAD)


def test_dropout_zoneout_and_variational_cells_in_train_mode():
    """Train mode: ``DropoutCell`` keeps about half of its input, scaled
    by 2; ``ZoneoutCell`` with both rates 1 keeps the zero previous
    output and the begin states; ``VariationalDropoutCell`` draws one
    mask of 0s and 2s per sequence and applies it at every step."""
    rs = _rs(9)
    with tmx.cpu(), tmx.autograd.train_mode():
        cell = trnn.DropoutCell(0.5)
        x = tmx.nd.ones((B, 200, I))
        out, _ = cell.unroll(200, x, merge_outputs=True)
        vals = np.unique(out.asnumpy())
        assert set(vals) <= {0.0, 2.0}
        assert abs((out.asnumpy() == 0).mean() - 0.5) < 0.05

        zone = trnn.ZoneoutCell(trnn.LSTMCell(H), 1.0, 1.0)
        zone.initialize()
        x = tmx.nd.array(rs.standard_normal((B, T, I)).astype(np.float32))
        begin = [tmx.nd.array(rs.standard_normal((B, H)).astype(np.float32))
                 for _ in range(2)]
        out, states = zone.unroll(T, x, begin_state=begin,
                                  merge_outputs=True)
        assert out.shape == (B, T, H) and not out.asnumpy().any()
        for s, b in zip(states, begin):
            np.testing.assert_array_equal(s.asnumpy(), b.asnumpy())

        var = tcrnn.VariationalDropoutCell(trnn.LSTMCell(H), 0.5, 0.5, 0.5)
        var.initialize()
        out, states = var.unroll(T, x, merge_outputs=False)
        assert len(out) == T and out[0].shape == (B, H)
        masks = [var.drop_inputs_mask, var.drop_states_mask,
                 var.drop_outputs_mask]
        assert [m.shape for m in masks] == [(B, I), (B, H), (B, H)]
        for m in masks:
            assert set(np.unique(m.asnumpy())) <= {0.0, 2.0}
        mask = var.drop_outputs_mask.asnumpy()
        for o in out:                       # one mask for every step
            assert not o.asnumpy()[mask == 0].any()
        var.reset()
        assert var.drop_inputs_mask is None


def test_stateful_cells_run_their_hybridized_steps_eagerly():
    """``ZoneoutCell`` keeps its previous output in Python: hybridized,
    its own steps run eagerly and are counted, and its outputs equal the
    unhybridized cell's in predict mode."""
    with tmx.cpu():
        base = trnn.LSTMCell(H)
        cell = trnn.ZoneoutCell(base, 0.3, 0.3)
        cell.initialize()
        x = tmx.nd.array(_seq("NTC", seed=10))
        want, _ = cell.unroll(T, x, merge_outputs=True)
        cell.hybridize()
        got, _ = cell.unroll(T, x, merge_outputs=True)
        assert cell.stats()["host_state_calls"] == T
    _close(got, want)


# -- npx.rnn ---------------------------------------------------------------------


def test_npx_rnn_keeps_the_np_class_and_matches_jax():
    ins, attrs = _op_inputs("lstm", 2, True, True, seed=11)
    with tmx.cpu():
        got = tmx.npx.rnn(*[tmx.np.array(a) for a in ins], **attrs)
    want = jmx.npx.rnn(*[jmx.np.array(a) for a in ins], **attrs)
    assert all(isinstance(g, tmx.np.ndarray) for g in got)
    _close(list(got), list(want))


# -- upstream's word language model (example/gluon/word_language_model) ---------


def _rnn_model(mx):
    from_gluon = mx.gluon

    class RNNModel(from_gluon.Block):
        def __init__(self, vocab_size, num_embed, num_hidden, num_layers,
                     dropout=0.5, **kwargs):
            super().__init__(**kwargs)
            nn, rnn = from_gluon.nn, from_gluon.rnn
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(
                    vocab_size, num_embed,
                    weight_initializer=mx.init.Uniform(0.1))
                self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                    input_size=num_embed)
                self.decoder = nn.Dense(vocab_size, in_units=num_hidden,
                                        params=self.encoder.params)
                self.num_hidden = num_hidden

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output.reshape((-1, self.num_hidden)))
            return decoded, hidden

    return RNNModel


def test_word_language_model_trains_as_jax():
    """``RNNModel`` (tied decoder) at V 50, E = H 16, 2 layers, T 7, B 4,
    dropout 0: three sgd steps with the script's clip and the hidden
    state carried and detached; losses and weights agree."""
    v, e, t, b = 50, 16, 7, 4
    stream = _rs(12).randint(0, v, (3 * t + 1, b)).astype(np.float32)
    models = {}
    for mx in (jmx, tmx):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            model = _rnn_model(mx)(v, e, e, 2, dropout=0.0)
            model.initialize(mx.init.Xavier())
            model(mx.nd.array(stream[:t]), model.rnn.begin_state(b))
            models[mx] = model
    with tmx.cpu():
        copy_params(models[jmx], models[tmx])
    runs = []
    for mx, model in models.items():
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                                       {"learning_rate": 0.5})
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            hidden = model.rnn.begin_state(b)
            losses = []
            for k in range(3):
                data = mx.nd.array(stream[k * t:(k + 1) * t])
                target = mx.nd.array(stream[k * t + 1:(k + 1) * t + 1])
                hidden = [h.detach() for h in hidden]
                with mx.autograd.record():
                    output, hidden = model(data, hidden)
                    L = loss_fn(output, target.reshape((-1,)))
                    L.backward()
                grads = [p.grad() for p in model.collect_params().values()]
                mx.gluon.utils.clip_global_norm(grads, 0.2 * t * b)
                trainer.step(b)
                losses.append(L.asnumpy())
            runs.append((losses, {k: p.data().asnumpy() for k, p in
                                  model.collect_params().items()}))
    (jl, jw), (tl, tw) = runs
    assert jl[-1].mean() < jl[0].mean()
    for a, w in zip(tl, jl):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5)
    assert list(tw) == list(jw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-4, atol=1e-5)
