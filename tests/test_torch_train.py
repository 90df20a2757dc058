"""The port's training path against the JAX package's, on the CPU:
``JitTrainStep`` + adamw, ``Trainer`` + adam, the optimizers' update
rules, ``SoftmaxCrossEntropyLoss``, ``Xavier``, and serving a model that
the port trained.  Weights are made by the JAX package and carried
across with ``load_jax_params``; batches come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import llama as jllama
from mxnet_tpu_torch import gluon, initializer, optimizer, parallel, serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import llama


def _twins(seed, tokens, **kw):
    """A JAX llama_small from ``seed`` and the port's copy of it."""
    mx.random.seed(seed)
    jnet = jllama.llama_small(**kw)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(tokens))
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = llama.llama_small(device="cpu", **kw)
    llama.load_jax_params(net, params)
    return jnet, net


def _batch(seed, vocab=512, shape=(2, 16)):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, shape).astype(np.float32),
            rs.randint(0, vocab, shape).astype(np.float32))


def test_jit_train_step_adamw_trajectory_matches_jax():
    """5 adamw steps from the same weights and batch: losses, weights
    after sync_params and the adamw mean/var agree (f32; Adam divides by
    sqrt(var), so ulp-level gradient differences grow to about 1e-5 in
    the weights)."""
    x, y = _batch(0)
    jnet, net = _twins(0, x)
    opt = {"learning_rate": 1e-3, "wd": 0.01}
    jstep = jparallel.JitTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                   "adamw", dict(opt))
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adamw", dict(opt))
    for _ in range(5):
        want = float(jstep.step(x, y))
        got = step.step(x, y)
        assert got.dim() == 0 and got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-5)
    jstep.sync_params()
    step.sync_params()
    jparams = jnet._collect_params_with_prefix()
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jparams[name].data().asnumpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # adamw state, matched by structural name
    jname = {id(p): n for n, p in jparams.items()}
    jstate = {jname[id(p)]: s for p, s in zip(jstep._params,
                                              jstep._opt_state)}
    for name, (mean, var) in zip(step._names, step._opt_state):
        jm, jv = (np.asarray(a) for a in jstate[name])
        scale = np.abs(jm).max() + 1e-12
        np.testing.assert_allclose(mean.numpy() / scale, jm / scale,
                                   atol=1e-3, err_msg=name)
        vscale = np.abs(jv).max() + 1e-20
        np.testing.assert_allclose(var.numpy() / vscale, jv / vscale,
                                   atol=1e-3, err_msg=name)


def test_step_n_equals_n_steps_and_jax_step_n():
    """``step_n(3)`` is three ``step()`` calls, bitwise (the update count
    advances on the device), and gives the JAX package's ``step_n``
    loss and weights (the trajectory case's tolerance)."""
    x, y = _batch(2)
    jnet, one = _twins(2, x)
    _, many = _twins(2, x)
    opt = {"learning_rate": 1e-3, "wd": 0.01}
    steps = [parallel.JitTrainStep(n, gluon.loss.SoftmaxCrossEntropyLoss(),
                                   "adamw", dict(opt)) for n in (one, many)]
    first = [steps[0].step(x, y) for _ in range(3)][-1]
    last = steps[1].step_n(3, x, y)
    assert torch.equal(first, last) and steps[1]._t == 3
    assert int(steps[1]._count) == 3
    for (name, a), b in zip(one.named_parameters(), many.parameters()):
        assert torch.equal(a, b), name
    jstep = jparallel.JitTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                   "adamw", dict(opt))
    np.testing.assert_allclose(last.item(), float(jstep.step_n(3, x, y)),
                               rtol=1e-5, atol=1e-5)
    jstep.sync_params()
    jparams = jnet._collect_params_with_prefix()
    for name, p in many.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jparams[name].data().asnumpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_learning_rate_change_between_steps_takes_effect():
    """``set_learning_rate`` between steps 3 and 4: the port follows the
    JAX package's JitTrainStep (whose jitted step takes lr as an
    argument), and differs from a run that kept the old rate."""
    x, y = _batch(3)
    jnet, net = _twins(3, x)
    _, kept = _twins(3, x)
    opt = {"learning_rate": 1e-3}
    jstep = jparallel.JitTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                   "adamw", dict(opt))
    step, ref = (parallel.JitTrainStep(
        n, gluon.loss.SoftmaxCrossEntropyLoss(), "adamw", dict(opt))
        for n in (net, kept))
    for i in range(5):
        if i == 3:
            jstep._opt.set_learning_rate(3e-2)
            step._opt.set_learning_rate(3e-2)
        got, want = step.step(x, y), float(jstep.step(x, y))
        np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-5)
        ref.step(x, y)
    jstep.sync_params()
    jparams = jnet._collect_params_with_prefix()
    moved = 0
    for (name, p), q in zip(net.named_parameters(), kept.parameters()):
        np.testing.assert_allclose(p.detach().numpy(),
                                   jparams[name].data().asnumpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        moved += not torch.equal(p, q)
    assert moved == len(list(net.parameters()))


def test_trainer_adam_matches_jax_and_converges():
    """test_llama.py's convergence case: the same 8 adam steps through
    the imperative form in both packages, then the 0.8x drop."""
    x, y = _batch(5)
    jnet, net = _twins(5, x)
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam",
                              {"learning_rate": 1e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(8):
        with autograd.record():
            jl = jloss(jnet(nd.array(x)).reshape(-3, 0),
                       nd.array(y).reshape(-1)).mean()
        jl.backward()
        jtrainer.step(1)
        loss = loss_fn(net(xt).reshape(-1, 512), yt.reshape(-1)).mean()
        loss.backward()
        trainer.step(1)
        losses.append(loss.item())
        np.testing.assert_allclose(losses[-1], float(jl.asscalar()),
                                   rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0] * 0.8


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(wd=0.1, clip_gradient=0.5, rescale_grad=0.5)),
    ("adam", dict(wd=0.1, clip_gradient=0.5, rescale_grad=0.5)),
    ("sgd", dict(momentum=0.9, wd=0.1, clip_gradient=0.5,
                 rescale_grad=0.5)),
])
def test_optimizer_step_matches_jax(name, kw):
    rs = np.random.RandomState(7)
    w0 = rs.randn(4, 33).astype(np.float32)
    grads = [rs.randn(4, 33).astype(np.float32) * 2 for _ in range(3)]
    jo = jopt.create(name, learning_rate=0.05, **kw)
    to = optimizer.create(name, learning_rate=0.05, **kw)
    jw, js = jnp.asarray(w0), jo.create_state(0, jnp.asarray(w0))
    tw = torch.from_numpy(w0.copy())
    ts = to.create_state(0, tw)
    for t, g in enumerate(grads, 1):
        jw, js = jo._step(jw, jnp.asarray(g), js, jnp.float32(0.05),
                          jnp.float32(kw["wd"]), jnp.int32(t))
        out_w, out_s = to._step(tw, torch.from_numpy(g), ts, 0.05,
                                kw["wd"], t)
        assert out_w is tw and out_s is ts        # in place
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    ts if isinstance(ts, tuple) else (ts,)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


def test_global_norm_clip_matches_jax():
    from mxnet_tpu.gluon.utils import global_norm_scale
    from mxnet_tpu_torch.parallel.train_step import _global_norm_scale

    rs = np.random.RandomState(13)
    grads = [rs.randn(3, 5).astype(np.float32) * 4, rs.randn(7)
             .astype(np.float32)]
    for max_norm in (1.0, 1e3):         # clipped, and left alone
        want, _ = global_norm_scale([jnp.asarray(g) for g in grads],
                                    max_norm)
        got = _global_norm_scale([torch.from_numpy(g) for g in grads],
                                 max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_optimizer_keeps_bf16_weights_and_state():
    """A bf16 parameter is updated in bf16 storage, within bf16 rounding
    of the f32 update."""
    rs = np.random.RandomState(8)
    w = torch.from_numpy(rs.randn(1000).astype(np.float32))
    g = torch.from_numpy(rs.randn(1000).astype(np.float32))
    opt = optimizer.create("adamw", learning_rate=0.1, wd=0.1)
    ref_w, ref_s = w.clone(), opt.create_state(0, w)
    opt._step(ref_w, g, ref_s, 0.1, 0.1, 1)
    bw = w.to(torch.bfloat16)
    bs = opt.create_state(0, bw)
    opt._step(bw, g.to(torch.bfloat16), bs, 0.1, 0.1, 1)
    assert bw.dtype == torch.bfloat16
    assert {s.dtype for s in bs} == {torch.bfloat16}
    np.testing.assert_allclose(bw.float().numpy(), ref_w.numpy(),
                               atol=2e-2)
    # the bf16 gradient is off by up to 2^-8 relative, its square by 2^-7
    for a, b in zip(bs, ref_s):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=2e-2,
                                   atol=1e-6)


@pytest.mark.parametrize("lr,wd", [(1e-3, 0.5), (1e-4, 0.1)])
def test_bf16_adamw_weight_rule_with_small_decay_matches_jax(lr, wd):
    """bf16 weights with lr*wd far below half a bf16 ulp.  The JAX rule
    forms the whole update, decay included, in f32 and rounds it once
    (JitTrainStep pins the new weight to bf16), so the decay still moves
    the rounding of some weights.  Given the same bf16 moments as the
    JAX step, the port's weight rule must give the same bf16 weights
    (up to one ulp where the f32 update lands within an f32 rounding of
    a bf16 boundary)."""
    rs = np.random.RandomState(21)
    jo = jopt.create("adamw", learning_rate=lr, wd=wd)
    to = optimizer.create("adamw", learning_rate=lr, wd=wd)
    jw = jnp.asarray(rs.randn(4096) * 0.01).astype(jnp.bfloat16)
    js = jo.create_state(0, jw)
    for t in range(1, 4):
        jg = jnp.asarray(rs.randn(4096)).astype(jnp.bfloat16)
        nw, ns = jo._step(jw, jg, js, jnp.float32(lr), wd, jnp.int32(t))
        js = tuple(s.astype(jnp.bfloat16) for s in ns)
        tw, mean, var = (torch.tensor(np.asarray(a.astype(jnp.float32)),
                                      dtype=torch.bfloat16)
                         for a in (jw,) + js)
        to._adam_step(tw, mean, var, lr, t, decay=lr * wd)
        jw = nw.astype(jnp.bfloat16)
        want = np.asarray(jw.astype(jnp.float32))
        got = tw.float().numpy()
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7)
        assert np.mean(got == want) >= 0.999


@pytest.mark.parametrize("wd", [1e-4, 1e-2])
def test_bf16_sgd_matches_jax_exactly(wd):
    """bf16 plain SGD, 20 steps on 65,536 weights.  The JAX rule forms
    ``w - lr * (g + wd * w)`` in f32 (its ``wd`` is an f32 scalar) and
    rounds it into bf16 once; given the same bf16 gradients, the port's
    weights must be EQUAL to the JAX package's after every step."""
    rs = np.random.default_rng(0)
    lr = 1e-2
    w0 = rs.standard_normal(65536).astype(np.float32)
    jo = jopt.create("sgd", learning_rate=lr, wd=wd)
    to = optimizer.create("sgd", learning_rate=lr, wd=wd)
    jw = jnp.asarray(w0).astype(jnp.bfloat16)
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    step = jo._get_jit_step()
    for t in range(1, 21):
        g = rs.standard_normal(65536).astype(np.float32)
        jw, _ = step(jw, jnp.asarray(g).astype(jnp.bfloat16), None,
                     jnp.float32(lr), jnp.float32(wd), jnp.int32(t))
        out, _ = to._step(tw, torch.from_numpy(g).to(torch.bfloat16), None,
                          lr, wd, t)
        assert out is tw and tw.dtype == torch.bfloat16
        assert jw.dtype == jnp.bfloat16
        np.testing.assert_array_equal(tw.float().numpy(),
                                      np.asarray(jw.astype(jnp.float32)))


@pytest.mark.parametrize("kw,label_kind", [
    ({}, "sparse"), (dict(from_logits=True), "sparse"),
    (dict(sparse_label=False), "dense"), (dict(axis=1), "sparse_axis1"),
])
def test_softmax_cross_entropy_matches_jax(kw, label_kind):
    rs = np.random.RandomState(9)
    pred = rs.randn(4, 6, 5).astype(np.float32)
    if label_kind == "sparse":
        label = rs.randint(-1, 7, (4, 6)).astype(np.float32)   # clipped
    elif label_kind == "sparse_axis1":
        label = rs.randint(0, 6, (4, 5)).astype(np.float32)
    else:
        label = rs.dirichlet(np.ones(5), (4, 6)).astype(np.float32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        nd.array(pred), nd.array(label)).asnumpy()
    got = gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(label))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # bf16 predictions still take their log-softmax in f32
    got16 = gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        torch.from_numpy(pred).to(torch.bfloat16), torch.from_numpy(label))
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
def test_xavier_matches_jax_by_moments(rnd_type):
    """Torch's generator and jax.random differ in values, so the two are
    compared by moments: mean 0 and the same standard deviation, within
    sampling error of 2^17 draws."""
    shape = (256, 512)
    mx.random.seed(10)
    jw = np.asarray(mx.init.Xavier(rnd_type=rnd_type)("w_weight", shape))
    gen = torch.Generator()
    gen.manual_seed(10)
    tw = initializer.Xavier(rnd_type=rnd_type)(
        "w.weight", torch.empty(shape), generator=gen).numpy()
    expect = np.sqrt(3.0 / ((256 + 512) / 2.0))
    if rnd_type == "uniform":
        assert np.abs(tw).max() <= expect
        expect /= np.sqrt(3.0)
    for w in (jw, tw):
        assert abs(w.mean()) < 4 * expect / np.sqrt(w.size)
        assert abs(w.std() / expect - 1) < 0.01
    gen2 = torch.Generator()
    gen2.manual_seed(10)
    again = initializer.Xavier(rnd_type=rnd_type)(
        "w.weight", torch.empty(shape), generator=gen2).numpy()
    np.testing.assert_array_equal(again, tw)


def test_initialize_honours_param_inits_and_lazy_dense():
    net = llama.llama_small(device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    net.initialize(initializer.Xavier(), generator=gen)
    assert torch.equal(net.norm.weight, torch.ones(64))
    assert net.embed.weight.std() > 0
    before = net.embed.weight.detach().clone()
    net.initialize(initializer.Zero())            # already initialized
    assert torch.equal(net.embed.weight, before)
    net.initialize(initializer.Zero(), force_reinit=True)
    assert not net.embed.weight.any() and net.norm.weight.all()
    dense = gluon.nn.Dense(3, use_bias=True, device="cpu")
    dense.initialize(initializer.One())
    out = dense(torch.ones(2, 4, 5))           # flatten: in_units = 20
    assert dense.weight.shape == (3, 20)
    np.testing.assert_array_equal(out.detach().numpy(), np.full((2, 3), 20))


def test_trainer_stale_gradients_and_single_device_guards():
    x, y = _batch(11)
    _, net = _twins(11, x)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(
        net(torch.from_numpy(x)), torch.from_numpy(y)).mean()
    loss.backward()
    trainer.step(2)
    with pytest.raises(MXNetError, match="has not been updated by"):
        trainer.step(2)
    trainer.step(2, ignore_stale_grad=True)
    with pytest.raises(MXNetError, match="S8"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    for kw in (dict(mesh={"data": 2}), dict(rules="dp"),
               dict(param_rule=lambda n, s: None)):
        with pytest.raises(MXNetError, match="S8"):
            parallel.JitTrainStep(net, None, "sgd", **kw)


def test_trained_model_serves_through_extract_weights():
    """A model the port trained, served by the port: prefill logits at
    the last position equal the LlamaModel's."""
    x, y = _batch(12, shape=(1, 16))
    _, net = _twins(12, x)
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adamw", {"learning_rate": 1e-3})
    for _ in range(2):
        step.step(x, y)
    g = serve.KVGeometry(num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, units=64, hidden_size=128,
                         vocab_size=512, page_size=8, num_pages=8,
                         max_pages_per_seq=4, max_batch=1,
                         prefill_buckets=(16,))
    weights = serve.convert_weights(serve.extract_weights(net),
                                    device="cpu")
    arena = serve.PagedKVArena(g, device="cpu")
    pages = arena.alloc(2, "test")
    row = torch.from_numpy(arena.block_row(pages))
    with torch.no_grad():
        got = serve.build_prefill_fn(weights, g, 16)(
            *arena.buffers(), torch.from_numpy(x[0]).int(), 16, row)[-1]
        want = net(torch.from_numpy(x))[0, -1]
    arena.free(pages, "test")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


class _JaxTwice(jgluon.HybridBlock):
    """One Dense used twice in a call: its weight gets two contributions
    in one backward (as BERT's tied word embedding does)."""

    def __init__(self):
        super().__init__()
        with self.name_scope():
            self.d = jgluon.nn.Dense(2, in_units=3)

    def hybrid_forward(self, F, x):
        return self.d(x) + self.d(x * 2)


class _PortTwice(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.d = gluon.nn.Dense(2, in_units=3, device="cpu")

    def forward(self, x):
        return self.d(x) + self.d(x * 2)


@pytest.mark.parametrize("case", ["two_backwards", "tied", "stale"])
def test_gluon_gradients_are_written_and_kept_as_in_jax(case):
    """The JAX package's ``grad_req="write"``: ``nn.Dense(2,
    in_units=3)`` with weights of ones and ``x = arange(6).reshape(2,
    3)``.  ``two_backwards``: two backward passes of ``net(x).sum()``
    give one pass's gradient, ``[[3, 5, 7], [3, 5, 7]]``, and it is still
    there after ``Trainer(sgd, lr 0).step(1)``; ``tied``: a weight used
    twice in one call gets both contributions, summed once per
    backward; ``stale``: after a step, a step without a new backward
    raises, and with ``ignore_stale_grad`` leaves the weights and the
    gradient as they are.  Gradients and weights equal the JAX
    package's."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    if case == "tied":
        jnet, net = _JaxTwice(), _PortTwice()
    else:
        jnet = jgluon.nn.Dense(2, in_units=3)
        net = gluon.nn.Dense(2, in_units=3, device="cpu")
    jnet.initialize(mx.init.One())
    net.initialize(initializer.One())
    lr = 0.0 if case == "two_backwards" else 0.1
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", {"learning_rate": lr})
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": lr})
    jw = [p for k, p in jnet._collect_params_with_prefix().items()
          if k.endswith("weight")][0]
    w = [p for k, p in net.named_parameters() if k.endswith("weight")][0]
    for _ in range(2):
        with autograd.record():
            jy = jnet(nd.array(x)).sum()
        jy.backward()
        net(torch.from_numpy(x)).sum().backward()
        np.testing.assert_array_equal(w.grad.numpy(), jw.grad().asnumpy())
    want = {"two_backwards": [[3, 5, 7]] * 2, "tied": [[9, 15, 21]] * 2,
            "stale": [[3, 5, 7]] * 2}[case]
    np.testing.assert_array_equal(w.grad.numpy(), np.float32(want))
    jtr.step(1)
    tr.step(1)
    np.testing.assert_array_equal(w.grad.numpy(), jw.grad().asnumpy())
    np.testing.assert_array_equal(w.detach().numpy(), jw.data().asnumpy())
    if case == "stale":
        before = w.detach().clone()
        for trainer in (jtr, tr):
            with pytest.raises(Exception, match="has not been updated by"):
                trainer.step(1)
            trainer.step(1, ignore_stale_grad=True)
        assert torch.equal(w.detach(), before)
        np.testing.assert_array_equal(w.detach().numpy(),
                                      jw.data().asnumpy())
        np.testing.assert_array_equal(w.grad.numpy(), np.float32(want))


def test_write_rule_holds_no_autograd_node_beyond_its_graph():
    """A block's call arms the ``AccumulateGrad`` nodes its graph holds
    and nothing more: once the graph is gone the parameter's next node
    is a new, unarmed one (a node records the stream it was made on, and
    one held past its graph would be used by a later CUDA graph capture
    on another stream).  Calls under ``grads_unwritten`` (as
    ``JitTrainStep`` makes them) arm nothing.  A tensor no block owns,
    given to a ``Trainer``, is armed by a hook on the tensor when a
    backward reaches it: the Trainer holds no node, two backward passes
    give one pass's gradient, and ``torch.autograd.grad`` leaves
    ``.grad`` alone."""
    from torch.autograd.graph import get_gradient_edge

    from mxnet_tpu_torch.gluon import block

    net = gluon.nn.Dense(2, in_units=3, device="cpu")
    net.initialize(initializer.One())
    x = torch.ones(2, 3)
    out = net(x)
    assert get_gradient_edge(net.weight).node.metadata.get("write_grads")
    out.sum().backward()
    del out
    assert not get_gradient_edge(net.weight).node.metadata.get("write_grads")
    with block.grads_unwritten():
        out = net(x)
    assert not get_gradient_edge(net.weight).node.metadata.get("write_grads")

    w = torch.ones(2, 3, requires_grad=True)
    tr = gluon.Trainer([w], "sgd", {"learning_rate": 0.0})
    assert not get_gradient_edge(w).node.metadata.get("write_grads")
    xs = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for _ in range(2):
        (xs @ w.t()).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(),
                                  np.float32([[3, 5, 7]] * 2))
    assert not get_gradient_edge(w).node.metadata.get("write_grads")
    tr.step(1)
    (g,) = torch.autograd.grad((2 * xs @ w.t()).sum(), [w])
    np.testing.assert_array_equal(g.numpy(), np.float32([[6, 10, 14]] * 2))
    np.testing.assert_array_equal(w.grad.numpy(),
                                  np.float32([[3, 5, 7]] * 2))
    with pytest.raises(Exception, match="has not been updated by"):
        tr.step(1)
