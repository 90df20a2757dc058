"""The port's optimizer tier against the JAX package's, on the CPU: every
optimizer of the registry, every update op of ``ops/optimizer_ops.py``,
the learning-rate schedulers, ``Updater`` and ``Trainer.save_states``.

Inputs are made from numpy seeds and handed to both packages.  On the
CPU the multi-tensor kernels O1-O3 run their plain versions; the card
holds the kernels against those (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).  Tolerances are those of
``test_torch_train.py::test_optimizer_step_matches_jax``: rtol 1e-5,
atol 1e-6 in f32 (Adam-type rules divide by ``sqrt(v)``, so f32
differences in the order of operations show at that level).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, lr_scheduler, optimizer
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import optimizer_ops as oo
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
SHAPES = ((4, 33), (7,))

COMMON = dict(wd=0.1, clip_gradient=0.5, rescale_grad=0.5)
OPTIMIZERS = [
    ("sgd", dict(momentum=0.9)),
    ("sgd", dict()),
    ("nag", dict(momentum=0.9)),
    ("nag", dict()),
    ("adam", dict()),
    ("adamw", dict()),
    ("adamax", dict()),
    ("lbsgd", dict(momentum=0.9, batch_scale=4, warmup_epochs=1,
                   updates_per_epoch=4)),
    ("lbsgd", dict(momentum=0.9, warmup_strategy="lars")),
    ("adagrad", dict()),
    ("adadelta", dict()),
    ("rmsprop", dict()),
    ("rmsprop", dict(centered=True, clip_weights=1.0)),
    ("ftrl", dict()),
    ("signum", dict()),
    ("signum", dict(momentum=0.0, wd_lh=0.01)),
    ("ftml", dict()),
    ("dcasgd", dict(momentum=0.9)),
    ("nadam", dict()),
    ("lamb", dict(lower_bound=0.1, upper_bound=5.0)),
    ("lars", dict()),
    ("test", dict()),
]


def _ids(cases):
    return ["%s-%s" % (n, "-".join("%s" % v for v in kw.values()) or "plain")
            for n, kw in cases]


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _jax_run(name, kw, w0, grads):
    jo = jopt.create(name, learning_rate=0.05, **COMMON, **kw)
    jw = jnp.asarray(w0)
    js = jo.create_state(0, jw)
    for t, g in enumerate(grads, 1):
        jw, js = jo._step(jw, jnp.asarray(g), js, jnp.float32(0.05),
                          jnp.float32(COMMON["wd"]), jnp.int32(t))
    return np.asarray(jw), [np.asarray(s) for s in _leaves(js)]


def _data(seed, shape):
    rs = np.random.RandomState(seed)
    w0 = rs.randn(*shape).astype(np.float32)
    return w0, [rs.randn(*shape).astype(np.float32) * 2 for _ in range(3)]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_every_optimizer_and_update_op_of_the_jax_package_exists():
    assert set(jopt.Optimizer.opt_registry) == set(
        optimizer.Optimizer.opt_registry)
    for name in jopt.Optimizer.opt_registry:
        assert isinstance(optimizer.create(name), optimizer.Optimizer)
    jax_ops = {n for n, r in jreg._REGISTRY.items()
               if r.forward.__module__ == "mxnet_tpu.ops.optimizer_ops"}
    assert len(jax_ops) == 39
    port_ops = {n for n, r in treg._REGISTRY.items()
                if r.forward.__module__ == oo.__name__}
    assert jax_ops == port_ops
    for n in jax_ops:
        assert hasattr(tmx.nd, n), n


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=_ids(OPTIMIZERS))
def test_optimizer_step_matches_jax_per_tensor_and_multi(name, kw):
    """3 steps in f32 with wd, clip_gradient and rescale_grad: ``_step``
    tensor by tensor, and ``_step_multi`` over both tensors at once,
    against the JAX package's ``_step``."""
    data = [_data(i, s) for i, s in enumerate(SHAPES)]
    want = [_jax_run(name, kw, w0, gs) for w0, gs in data]
    to = optimizer.create(name, learning_rate=0.05, **COMMON, **kw)
    ws = [torch.from_numpy(w0.copy()) for w0, _ in data]
    ss = [to.create_state(i, w) for i, w in enumerate(ws)]
    for t in range(1, 4):
        for w, s, (_, gs) in zip(ws, ss, data):
            out_w, out_s = to._step(w, torch.from_numpy(gs[t - 1]), s, 0.05,
                                    COMMON["wd"], t)
            assert out_w is w and out_s is s           # in place
    to_m = optimizer.create(name, learning_rate=0.05, **COMMON, **kw)
    wm = [torch.from_numpy(w0.copy()) for w0, _ in data]
    sm = [to_m.create_state(i, w) for i, w in enumerate(wm)]
    for t in range(1, 4):
        to_m._step_multi(wm, [torch.from_numpy(gs[t - 1]) for _, gs in data],
                         sm, torch.tensor(0.05), [COMMON["wd"]] * 2,
                         torch.tensor(t, dtype=torch.int32))
    for i, (jw, js) in enumerate(want):
        for what, w, s in (("_step", ws[i], ss[i]),
                           ("_step_multi", wm[i], sm[i])):
            _close(w.numpy(), jw, "%s weight %d" % (what, i))
            got = [x.numpy() for x in _leaves(s)]
            assert len(got) == len(js)
            for a, b in zip(got, js):
                _close(a, b, "%s state %d" % (what, i))


def test_sgld_matches_jax_by_moments():
    """SGLD's noise: threefry in the JAX package, Philox here; with a zero
    gradient the step is ``N(0, lr)`` noise, so mean and std agree."""
    lr, n = 0.04, 200000
    jo, to = jopt.create("sgld", learning_rate=lr), \
        optimizer.create("sgld", learning_rate=lr)
    jw, _ = jo._step(jnp.zeros(n), jnp.zeros(n), jo.create_state(0, None),
                     jnp.float32(lr), jnp.float32(0.0), jnp.int32(1))
    tw = torch.zeros(n)
    to._step(tw, torch.zeros(n), to.create_state(0, tw), lr, 0.0, 1)
    for got in (np.asarray(jw), tw.numpy()):
        assert abs(got.mean()) < 5 * np.sqrt(lr / n)
        assert abs(got.std() - np.sqrt(lr)) < 0.01 * np.sqrt(lr)
    # the deterministic part: w - lr/2 * (g + wd w)
    w0, g = np.ones(4, np.float32), np.full(4, 2.0, np.float32)
    tw = torch.from_numpy(w0.copy())
    to._generator(tw.device).manual_seed(0)
    noise = torch.randn(4, generator=torch.Generator().manual_seed(0))
    to._step(tw, torch.from_numpy(g), None, lr, 0.1, 1)
    _close(tw.numpy(), w0 - 0.5 * lr * (g + 0.1 * w0)
           + noise.numpy() * np.sqrt(np.float32(lr)), "sgld")


def _op_inputs(spec, seed):
    """One input per kind, from a numpy seed: ``w`` weight, ``g``
    gradient, ``z`` zero-mean state, ``p`` positive state, ``s`` a (1,)
    scalar, ``s2`` a (2,) rate or decay array, ``vec`` a positive (4,)
    vector, ``hist`` a positive per-row (5,) history; ``wb``/``gb`` a
    bf16 weight/gradient and ``m32`` the f32 master of the last ``wb``.
    Returns (torch tensors, jax arrays)."""
    rs = np.random.RandomState(seed)
    port, jaxs = [], []
    master = None
    for kind in spec:
        if kind in ("w", "wb"):
            a = rs.randn(5, 6).astype(np.float32)
        elif kind == "z":
            a = rs.randn(5, 6).astype(np.float32) * 0.3
        elif kind in ("g", "gb"):
            a = rs.randn(5, 6).astype(np.float32) * 2
        elif kind == "p":
            a = (rs.rand(5, 6) + 0.5).astype(np.float32)
        elif kind == "s":
            a = np.asarray([rs.rand() + 0.5], np.float32)
        elif kind == "s2":
            a = (rs.rand(2) * 0.2 + 0.05).astype(np.float32)
        elif kind == "vec":
            a = (rs.rand(4) + 0.1).astype(np.float32)
        elif kind == "hist":
            a = (rs.rand(5) + 0.5).astype(np.float32)
        elif kind == "m32":
            a = master
        else:
            raise ValueError(kind)
        if kind in ("wb", "gb"):
            t = torch.from_numpy(a).to(torch.bfloat16)
            if kind == "wb":
                master = t.float().numpy() + np.float32(1e-3)
            port.append(t)
            jaxs.append(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
            continue
        port.append(torch.from_numpy(a.copy()))
        jaxs.append(jnp.asarray(a))
    return port, jaxs


W = ("w", "g")
OPS = [
    ("sgd_update", W, dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                           clip_gradient=0.4)),
    ("sgd_mom_update", W + ("z",), dict(lr=0.1, momentum=0.9, wd=0.01,
                                        rescale_grad=0.5, clip_gradient=0.4)),
    ("nag_mom_update", W + ("z",), dict(lr=0.1, momentum=0.9, wd=0.01,
                                        rescale_grad=0.5)),
    ("adam_update", W + ("z", "p"), dict(lr=0.01, wd=0.01, rescale_grad=0.5,
                                         clip_gradient=0.4)),
    ("adamw_update", W + ("z", "p"), dict(lr=0.01, wd=0.01, eta=0.5,
                                          rescale_grad=0.5)),
    ("rmsprop_update", W + ("p",), dict(lr=0.01, wd=0.01, clip_weights=1.0)),
    ("rmspropalex_update", W + ("p", "z", "z"), dict(lr=0.01, wd=0.01,
                                                     rescale_grad=0.2)),
    ("ftrl_update", W + ("z", "p"), dict(lr=0.1, wd=0.01, lamda1=0.2)),
    ("signsgd_update", W, dict(lr=0.1, wd=0.01)),
    ("signum_update", W + ("z",), dict(lr=0.1, momentum=0.9, wd=0.01,
                                       wd_lh=0.01)),
    ("lamb_update_phase1", W + ("z", "p"), dict(t=3, wd=0.01,
                                                clip_gradient=1.0)),
    ("lamb_update_phase2", W + ("s", "s"), dict(lr=0.1, lower_bound=0.5,
                                                upper_bound=4.0)),
    ("multi_sum_sq", ("w", "g", "p"), dict(num_arrays=3)),
    ("ftml_update", W + ("p", "p", "z"), dict(lr=0.1, t=2, wd=0.01,
                                              clip_grad=3.0)),
    ("mp_sgd_update", ("wb", "gb", "m32"), dict(lr=0.1, wd=0.01)),
    ("mp_sgd_mom_update", ("wb", "gb", "z", "m32"), dict(lr=0.1,
                                                          momentum=0.9)),
    ("mp_nag_mom_update", ("wb", "gb", "z", "m32"), dict(lr=0.1,
                                                          momentum=0.9)),
    ("_adamw_update", W + ("z", "p", "s"), dict(lr=0.01, wd=0.01, eta=0.5,
                                                clip_gradient=0.4)),
    ("_mp_adamw_update", ("wb", "gb", "z", "p", "m32", "s"),
     dict(lr=0.01, wd=0.01, eta=0.5)),
    ("multi_sgd_update", W * 2, dict(lrs=(0.1, 0.2), wds=(0.0, 0.01),
                                     rescale_grad=0.5, num_weights=2)),
    ("multi_sgd_mom_update", (W + ("z",)) * 2,
     dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), momentum=0.9, num_weights=2)),
    ("multi_mp_sgd_update", ("wb", "gb", "m32") * 2,
     dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), num_weights=2)),
    ("multi_mp_sgd_mom_update", ("wb", "gb", "z", "m32") * 2,
     dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), momentum=0.9, num_weights=2)),
    ("preloaded_multi_sgd_update", W * 2 + ("s2", "s2"),
     dict(rescale_grad=0.5, num_weights=2)),
    ("preloaded_multi_sgd_mom_update", (W + ("z",)) * 2 + ("s2", "s2"),
     dict(momentum=0.9, num_weights=2)),
    ("preloaded_multi_mp_sgd_update", ("wb", "gb", "m32") * 2
     + ("s2", "s2"), dict(num_weights=2)),
    ("preloaded_multi_mp_sgd_mom_update", ("wb", "gb", "z", "m32") * 2
     + ("s2", "s2"), dict(momentum=0.9, num_weights=2)),
    ("multi_lars", ("vec",) * 4, dict(eta=0.01, eps=1e-8, rescale_grad=0.5)),
    ("mp_lamb_update_phase1", ("wb", "gb", "z", "p", "m32"),
     dict(t=2, wd=0.01)),
    ("mp_lamb_update_phase2", ("wb", "g", "s", "s", "m32"), dict(lr=0.1)),
    ("_multi_lamb_update", (W + ("z", "p")) * 2,
     dict(learning_rates=(0.01, 0.02), wds=(0.0, 0.01), step_count=(1, 3),
          lower_bound=0.2, upper_bound=5.0, num_tensors=2)),
    ("_multi_mp_lamb_update", ("wb", "gb", "z", "p", "m32") * 2,
     dict(learning_rates=(0.01, 0.02), wds=(0.0, 0.01), step_count=(2, 2),
          num_tensors=2)),
    ("_multi_adamw_update", (W + ("z", "p")) * 2 + ("s",),
     dict(lrs=(0.01, 0.02), wds=(0.0, 0.01), etas=(1.0, 0.5),
          clip_gradient=0.4, num_weights=2)),
    ("_multi_mp_adamw_update", ("wb", "gb", "z", "p", "m32") * 2 + ("s",),
     dict(lrs=(0.01, 0.02), wds=(0.0, 0.01), etas=(1.0, 0.5),
          num_weights=2)),
    ("_contrib_group_adagrad_update", W + ("hist",), dict(lr=0.1,
                                                          rescale_grad=0.5)),
    ("all_finite", ("g",), dict()),
    ("multi_all_finite", ("g", "w"), dict(num_arrays=2)),
    ("reset_arrays", ("w", "g"), dict(num_arrays=2)),
]


def _outputs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("name,spec,attrs", OPS, ids=[o[0] for o in OPS])
def test_update_op_matches_jax_through_the_registry(name, spec, attrs):
    port, jaxs = _op_inputs(spec, 3)
    want = _outputs(jreg.get(name).forward(*jaxs, **attrs))
    got = _outputs(treg.get(name).forward(*port, **attrs))
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape, (k, a.shape, b.shape)
        bf16_out = isinstance(got[k], torch.Tensor) \
            and got[k].dtype == torch.bfloat16
        # a bf16 output rounds an f32 value: one bf16 ulp where the two
        # f32 values straddle a rounding boundary
        np.testing.assert_allclose(a, b, rtol=2.0 ** -8 if bf16_out
                                   else RTOL, atol=ATOL,
                                   err_msg="%s output %d" % (name, k))


def test_update_ops_write_in_place_and_take_out_through_nd():
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    g = np.ones((3, 4), np.float32)
    with tmx.cpu():
        tw, tg = tmx.nd.array(w), tmx.nd.array(g)
        res = tmx.nd.sgd_update(tw, tg, lr=0.5, out=tw)
        assert res is tw
        np.testing.assert_allclose(tw.asnumpy(), w - 0.5, rtol=1e-6)
        mom = tmx.nd.zeros((3, 4))
        tmx.nd.sgd_mom_update(tw, tg, mom, lr=0.5, momentum=0.9)
        np.testing.assert_allclose(mom.asnumpy(), np.full((3, 4), -0.5))
        np.testing.assert_allclose(tw.asnumpy(), w - 1.0, rtol=1e-6)
        # _sparse_adagrad_update raised here until sparse storage landed;
        # now it computes on dense inputs as the JAX package's op does
        w1 = tw.asnumpy()
        hist = tmx.nd.zeros((3, 4))
        tmx.nd._sparse_adagrad_update(tw, tg, hist, lr=0.1,
                                      rescale_grad=0.5, clip_gradient=0.3)
        jw, jh = mx.nd._sparse_adagrad_update(
            mx.nd.array(w1), mx.nd.array(g), mx.nd.zeros((3, 4)), lr=0.1,
            rescale_grad=0.5, clip_gradient=0.3)
        np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(hist.asnumpy(), jh.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
        with pytest.raises(ValueError, match="wd must be 0"):
            tmx.nd._sparse_adagrad_update(tw, tg, hist, wd=0.1)


def test_multi_all_finite_with_a_planted_inf_and_nan():
    rs = np.random.RandomState(5)
    arrays = [rs.randn(300).astype(np.float32) for _ in range(3)]
    for bad, want in ((None, 1.0), (np.inf, 0.0), (np.nan, 0.0),
                      (-np.inf, 0.0)):
        xs = [a.copy() for a in arrays]
        if bad is not None:
            xs[1][123] = bad
        j = jreg.get("multi_all_finite").forward(*map(jnp.asarray, xs),
                                                 num_arrays=3)
        t = treg.get("multi_all_finite").forward(*map(torch.from_numpy, xs),
                                                 num_arrays=3)
        assert float(np.asarray(j)[0]) == want == float(t[0])
        bf = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
        assert float(oo.multi_sum_sq(bf)[1][0]) == want


def test_multi_sum_sq_matches_f64_and_keeps_list_order():
    rs = np.random.RandomState(6)
    xs = [rs.randn(n).astype(np.float32) for n in (1, 8191, 8193, 0, 40000)]
    sums, flag = oo.multi_sum_sq([torch.from_numpy(x) for x in xs])
    want = [np.sum(x.astype(np.float64) ** 2) for x in xs]
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-7)
    assert float(flag[0]) == 1.0


def test_multi_sum_sq_and_has_overflow_take_strided_cpu_views():
    """On the CPU the plain version reads any strides (the card's O3 needs
    dense tensors), so amp's overflow check still takes a strided
    gradient view there."""
    from mxnet_tpu_torch.amp.loss_scaler import LossScaler

    x = torch.from_numpy(np.random.RandomState(7).randn(6, 10)
                         .astype(np.float32))[:, ::2]
    assert not x.is_contiguous()
    sums, flag = oo.multi_sum_sq([x])
    np.testing.assert_allclose(sums.numpy(),
                               [np.sum(x.numpy().astype(np.float64) ** 2)],
                               rtol=1e-7)
    assert float(flag[0]) == 1.0

    class P:
        grad = x

    assert not LossScaler().has_overflow([P()])
    x[1, 2] = float("inf")
    assert LossScaler().has_overflow([P()])


def _bf16_ulps(got, want):
    """Per-element distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).to(torch.int64)
        return torch.where(b < 0, -(b & 0x7FFF), b)

    return (ordered(got) - ordered(want)).abs()


def test_bf16_adamw_step_multi_is_bitwise_the_per_tensor_step():
    """bf16 AdamW over a list, 3 steps: ``_step_multi`` bitwise equal to
    ``_step`` tensor by tensor, and at each step, on the same bf16
    weights, states and gradients, held against the JAX package:

    - the moments within one bf16 ulp of its jitted step
      (``_get_jit_step``) taken in f32 and rounded once into bf16, and
      equal in at least 99.9% of elements (the port's rule: f32
      intermediates, one rounding; the JAX step on bf16 state rounds
      after each operation instead);
    - the weights bitwise equal to its bf16 ``_step``, op by op, wherever
      that step's bf16 moments equal the port's (the weight rule reads
      the stored moments, as the JAX package's does), which is at least
      40% of the elements.  Its jitted bf16 step is not the yardstick
      here: XLA may drop the bf16 roundings between its operations."""
    rs = np.random.RandomState(8)
    shapes = [(64, 33), (5,), (1, 300), (17, 3, 3)]
    kw = dict(learning_rate=1e-2, wd=0.1, clip_gradient=1.0,
              rescale_grad=0.5)
    opt = optimizer.create("adamw", **kw)
    jo = jopt.create("adamw", **kw)
    jit_step = jo._get_jit_step()
    a = [torch.from_numpy(rs.randn(*s).astype(np.float32))
         .to(torch.bfloat16) for s in shapes]
    b = [w.clone() for w in a]
    sa = [opt.create_state(i, w) for i, w in enumerate(a)]
    sb = [opt.create_state(i, w) for i, w in enumerate(b)]

    def to_jax(t, dtype):
        return jnp.asarray(t.float().numpy()).astype(dtype)

    def to_bf16(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))) \
            .to(torch.bfloat16)

    moment_ulps, weight_ulps, agree = [], [], []
    for t in range(1, 4):
        gs = [torch.from_numpy(rs.randn(*s).astype(np.float32))
              .to(torch.bfloat16) for s in shapes]
        want = []
        for w, g, (m, v) in zip(b, gs, sb):
            args = (jnp.float32(1e-2), jnp.float32(0.1), jnp.int32(t))
            _, moments32 = jit_step(*(to_jax(x, jnp.float32)
                                      for x in (w, g)),
                                    tuple(to_jax(x, jnp.float32)
                                          for x in (m, v)), *args)
            w16, moments16 = jo._step(*(to_jax(x, jnp.bfloat16)
                                        for x in (w, g)),
                                      tuple(to_jax(x, jnp.bfloat16)
                                            for x in (m, v)), *args)
            want.append([to_bf16(x) for x in (w16, *moments32, *moments16)])
        for w, g, s in zip(a, gs, sa):
            opt._step(w, g, s, 1e-2, 0.1, t)
        opt._step_multi(b, gs, sb, 1e-2, [0.1] * len(b), t)
        for w, (m, v), (w16, m32, v32, m16, v16) in zip(b, sb, want):
            moment_ulps += [_bf16_ulps(m, m32).reshape(-1),
                            _bf16_ulps(v, v32).reshape(-1)]
            same = ((m == m16) & (v == v16)).reshape(-1)
            agree.append(same)
            weight_ulps.append(_bf16_ulps(w, w16).reshape(-1)[same])
    for x, y in zip(a + [s for st in sa for s in st],
                    b + [s for st in sb for s in st]):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y)
    moment_ulps = torch.cat(moment_ulps)
    assert moment_ulps.max().item() <= 1
    assert (moment_ulps == 0).double().mean().item() >= 0.999
    assert torch.cat(agree).double().mean().item() >= 0.4
    assert torch.cat(weight_ulps).max().item() == 0


def test_update_raises_on_state_with_other_strides():
    opt = optimizer.create("adam")
    w = torch.randn(4, 6)
    state = (torch.zeros(6, 4).t(), torch.zeros(4, 6))
    with pytest.raises(MXNetError, match="strides"):
        opt._step(w, torch.randn(4, 6), state, 0.1, 0.0, 1)
    cl = torch.randn(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)
    st = opt.create_state(0, cl)
    assert st[0].stride() == cl.stride()
    opt._step(cl, torch.randn(2, 3, 4, 5).contiguous(
        memory_format=torch.channels_last), st, 0.1, 0.0, 1)


SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.1, warmup_steps=5,
                             warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[10, 20, 30], factor=0.3,
                                  base_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[3, 40], factor=0.5, base_lr=0.2,
                                  warmup_steps=2, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                           final_lr=0.001, warmup_steps=5)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.1, final_lr=0.002,
                             warmup_steps=3, warmup_begin_lr=0.01)),
]


@pytest.mark.parametrize("cls,kw", SCHEDULERS, ids=[
    "%s-%d" % (c, i) for i, (c, _) in enumerate(SCHEDULERS)])
def test_scheduler_matches_jax(cls, kw):
    js, ts = getattr(jsched, cls)(**kw), getattr(lr_scheduler, cls)(**kw)
    assert [ts(t) for t in range(51)] == [js(t) for t in range(51)]
    js, ts = getattr(jsched, cls)(**kw), getattr(lr_scheduler, cls)(**kw)
    want = np.array([np.asarray(js.traced(jnp.int32(t))) for t in
                     range(51)], np.float32)
    got = np.array([ts.traced(torch.tensor(t, dtype=torch.int32)).item()
                    for t in range(51)], np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert lr_scheduler.LRScheduler().traced(torch.tensor(1)) is None


def test_optimizer_with_a_scheduler_follows_it_like_jax():
    kw = dict(step=2, factor=0.5)
    jo = jopt.create("sgd", learning_rate=0.4,
                     lr_scheduler=jsched.FactorScheduler(**kw))
    to = optimizer.create("sgd", learning_rate=0.4,
                          lr_scheduler=lr_scheduler.FactorScheduler(**kw))
    jw, tw = nd.array(np.ones(3, np.float32)), torch.ones(3)
    for _ in range(6):
        jo.update(0, jw, nd.array(np.ones(3, np.float32)), None)
        to.update(0, tw, torch.ones(3), None)
        assert to.learning_rate == jo.learning_rate
    _close(tw.numpy(), jw.asnumpy(), "sgd with a FactorScheduler")


def test_updater_state_round_trips():
    rs = np.random.RandomState(9)
    opt = optimizer.create("adam", learning_rate=0.01, wd=0.01)
    up = optimizer.get_updater(opt)
    ws = [torch.from_numpy(rs.randn(3, 4).astype(np.float32)) for _ in
          range(2)]
    grads = [[torch.from_numpy(rs.randn(3, 4).astype(np.float32))
              for _ in range(2)] for _ in range(3)]
    for i in range(2):
        up(i, grads[0][i], ws[i])
    blob = up.get_states()
    states = pickle.loads(blob)
    assert all(isinstance(a, np.ndarray) for s in states.values() for a in s)
    twin = optimizer.get_updater(optimizer.create("adam", learning_rate=0.01,
                                                  wd=0.01))
    twin.set_states(blob)
    twin.optimizer._index_update_count = dict(opt._index_update_count)
    copies = [w.clone() for w in ws]
    for k in (1, 2):
        for i in range(2):
            up(i, grads[k][i], ws[i])
            twin(i, grads[k][i], copies[i])
    for a, b in zip(ws, copies):
        assert torch.equal(a, b)
    states, opt2 = pickle.loads(up.get_states(dump_optimizer=True))
    assert isinstance(opt2, optimizer.Adam) and set(states) == {0, 1}


# -- Trainer.save_states across the two packages ------------------------------

def _jax_trainer(ws):
    params = []
    for i, w in enumerate(ws):
        p = jgluon.Parameter("w%d" % i, shape=w.shape)
        p.initialize()
        p.set_data(nd.array(w))
        params.append(p)
    return params, jgluon.Trainer(params, "adam", {"learning_rate": 0.05,
                                                   "wd": 0.01})


def _port_trainer(ws):
    params = [torch.from_numpy(w.copy()).requires_grad_() for w in ws]
    return params, gluon.Trainer(params, "adam", {"learning_rate": 0.05,
                                                  "wd": 0.01})


def _target(i):
    return np.linspace(-1, 1, 12).astype(np.float32).reshape(3, 4) * (i + 1)


def _jax_steps(params, trainer, n):
    for _ in range(n):
        with autograd.record():
            loss = sum((((p.data() - nd.array(_target(i))) ** 2).sum()
                        for i, p in enumerate(params)))
        loss.backward()
        trainer.step(1)


def _port_steps(params, trainer, n):
    for _ in range(n):
        loss = sum(((p - torch.from_numpy(_target(i))) ** 2).sum()
                   for i, p in enumerate(params))
        loss.backward()
        trainer.step(1)


def _values(params):
    """Copies: a view of a port tensor handed to the JAX package may be
    aliased by it on the CPU, and the port updates in place."""
    return [p.data().asnumpy().copy() if hasattr(p, "set_data") else
            p.detach().numpy().copy() for p in params]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trainer_states_cross_between_the_packages(writer, tmp_path):
    """Two steps in the writing package, ``save_states``; the reading
    package takes the weights and ``load_states``; two more steps in
    both agree within 1e-5 (Adam's bias correction continues from the
    saved counts)."""
    ws = [np.random.RandomState(11 + i).randn(3, 4).astype(np.float32)
          for i in range(2)]
    fname = str(tmp_path / "trainer.states")
    if writer == "jax":
        src, trainer = _jax_trainer(ws)
        _jax_steps(src, trainer, 2)
        trainer.save_states(fname)
        dst, other = _port_trainer(_values(src))
        other.load_states(fname)
        _jax_steps(src, trainer, 2)
        _port_steps(dst, other, 2)
    else:
        src, trainer = _port_trainer(ws)
        _port_steps(src, trainer, 2)
        trainer.save_states(fname)
        dst, other = _jax_trainer(_values(src))
        other.load_states(fname)
        _port_steps(src, trainer, 2)
        _jax_steps(dst, other, 2)
    assert other.optimizer.num_update == trainer.optimizer.num_update == 4
    for a, b in zip(_values(src), _values(dst)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_trainer_legacy_pickle_and_corrupt_file(tmp_path):
    ws = [np.ones((3, 4), np.float32)]
    params, trainer = _port_trainer(ws)
    _port_steps(params, trainer, 1)
    legacy = str(tmp_path / "legacy.states")
    with open(legacy, "wb") as f:
        pickle.dump({"states": [tuple(s.numpy() * 2 for s in
                                      trainer._states[0])],
                     "num_update": 7, "index_update_count": {0: 7}}, f)
    trainer.load_states(legacy)
    assert trainer.optimizer.num_update == 7
    assert float(trainer._states[0][1].sum()) > 0
    bad = str(tmp_path / "bad.states")
    with open(bad, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(MXNetError, match="neither MXGC1"):
        trainer.load_states(bad)


def test_trainer_step_groups_by_update_count():
    """Under ``ignore_stale_grad`` counts differ per index: each group's
    count reaches the update (Adam's bias correction), as in the JAX
    package."""
    ws = [np.full((2, 2), 1.0, np.float32), np.full((3,), 2.0, np.float32)]
    params = [torch.from_numpy(w.copy()).requires_grad_() for w in ws]
    tr = gluon.Trainer(params, "adam", {"learning_rate": 0.1})
    jparams = []
    for i, w in enumerate(ws):
        p = jgluon.Parameter("q%d" % i, shape=w.shape)
        p.initialize()
        p.set_data(nd.array(w))
        jparams.append(p)
    jtr = jgluon.Trainer(jparams, "adam", {"learning_rate": 0.1})
    for step, used in enumerate(([0, 1], [0], [0, 1])):
        loss = sum((params[i] ** 2).sum() for i in used)
        loss.backward()
        tr.step(1, ignore_stale_grad=True)
        with autograd.record():
            jl = sum(((jparams[i].data() ** 2).sum() for i in used))
        jl.backward()
        jtr.step(1, ignore_stale_grad=True)
    assert tr.optimizer._index_update_count == {0: 3, 1: 2}
    for a, b in zip(_values(params), _values(jparams)):
        _close(a, b, "adam with stale gradients")


def test_jax_tree_of_states_is_the_ports_leaf_order():
    jo = jopt.create("rmsprop", centered=True)
    leaves = jax.tree_util.tree_leaves(jo.create_state(0, jnp.zeros(3)))
    to = optimizer.create("rmsprop", centered=True)
    assert len(leaves) == len(_leaves(to.create_state(0, torch.zeros(3))))
