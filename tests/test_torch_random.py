"""The port's random tier (``mx.random``, ``mx.nd.random`` and the ops of
``ops/random_ops.py``) against the JAX package's and scipy's, on the
CPU.

The port draws from torch's Philox and CPU generators, the JAX package
from threefry keys, so samplers are compared by moments, never by
value: each sampler's 2^16 draws have their mean and variance within 5
standard errors of the scipy distribution's (the same readings the
smoke's ``ops`` phase takes on the card, ``chip_smoke.draw_readings``),
a continuous one its KS statistic under the critical value at
alpha 1e-6, and the port's mean and variance agree with the JAX
package's own draws within 5 standard errors of their difference.  All
draws are seeded, so a pass is deterministic.

The ``_random_pdf_*`` ops are compared by value (rtol 1e-5 / atol 1e-6)
and by gradient (``jax.vjp`` of the JAX op, rtol 1e-4 / atol 1e-5).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as jmx
import mxnet_tpu.ops.random_ops  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import registry as treg

N = 1 << 16
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
LABELS = ([s[0] for s in chip_smoke.SAMPLERS]
          + ["%s[%d]" % (s[0], i) for s in chip_smoke.SAMPLE_ROWS
             for i in range(2)] + ["multinomial"])


@pytest.fixture(scope="module")
def readings():
    return chip_smoke.draw_readings("cpu", N, 3)


@pytest.mark.parametrize("label", LABELS)
def test_sampler_matches_its_distribution(readings, label):
    r = readings[label]
    assert r["n"] == N
    assert chip_smoke.draw_ok(r), r


def test_shuffle_permutes_rows(readings):
    r = readings["shuffle"]
    assert r["permutes"] and r["moved"] > 0.99, r
    x = torch.arange(12.0).reshape(6, 2)
    (y,), _, _ = treg.invoke_raw("_shuffle", (x,))
    assert sorted(y[:, 0].tolist()) == x[:, 0].tolist()
    assert torch.equal(y[:, 1] - y[:, 0], torch.ones(6))    # rows intact


def _jax_draws(op, attrs, n, key):
    fwd = jreg.get(op).forward
    return np.asarray(fwd(jax.random.PRNGKey(key), shape=(n,), **attrs),
                      np.float64)


@pytest.mark.parametrize("spec", chip_smoke.SAMPLERS,
                         ids=[s[0] for s in chip_smoke.SAMPLERS])
def test_sampler_matches_jax_by_moments(spec):
    """The port's draws against the JAX package's: mean and variance
    within 5 standard errors of their difference."""
    label, op, attrs, name, args, _ = spec
    want = _jax_draws(op, attrs, N, 1)
    tmx.random.seed(4)
    (got,), _, _ = treg.invoke_raw(op, (), dict(attrs, shape=(N,),
                                                ctx=tmx.cpu()))
    got = got.numpy().astype(np.float64)
    dist = chip_smoke.scipy_dist(name, args)
    m, var, kurt = (float(x) for x in dist.stats(moments="mvk"))
    mu4 = (kurt + 3.0) * var * var
    se_mean = math.sqrt(2 * var / N)
    se_var = math.sqrt(2 * (mu4 - var * var) / N)
    assert abs(got.mean() - want.mean()) <= 5 * se_mean, \
        (got.mean(), want.mean())
    assert abs(got.var() - want.var()) <= 5 * se_var, (got.var(), want.var())


@pytest.mark.parametrize("spec", chip_smoke.SAMPLE_ROWS,
                         ids=[s[0] for s in chip_smoke.SAMPLE_ROWS])
def test_sample_ops_match_jax_by_moments(spec):
    """Per parameter row: the port's draws against the JAX package's."""
    label, op, params, name, args_of, _ = spec
    a, b = (np.asarray(x, np.float32) for x in params)
    want = np.asarray(jreg.get(op).forward(
        jax.random.PRNGKey(2), jnp.asarray(a), jnp.asarray(b), shape=(N,)),
        np.float64)
    tmx.random.seed(5)
    (got,), _, _ = treg.invoke_raw(op, (torch.from_numpy(a),
                                        torch.from_numpy(b)),
                                   dict(shape=(N,)))
    got = got.numpy().astype(np.float64)
    assert got.shape == want.shape == (2, N)
    for i in range(2):
        dist = chip_smoke.scipy_dist(name, args_of(a[i], b[i]))
        var = float(dist.var())
        assert abs(got[i].mean() - want[i].mean()) \
            <= 5 * math.sqrt(2 * var / N)


def test_multinomial_matches_jax_and_ignores_get_prob():
    p = np.asarray(chip_smoke.MULTINOMIAL_P, np.float32)
    data = np.stack([p, p[::-1]])
    want = np.asarray(jreg.get("_sample_multinomial").forward(
        jax.random.PRNGKey(3), jnp.asarray(data), shape=(N,),
        get_prob=True))
    tmx.random.seed(6)
    outs, _, _ = treg.invoke_raw("_sample_multinomial",
                                 (torch.from_numpy(data),),
                                 dict(shape=(N,), get_prob=True))
    assert len(outs) == 1
    got = outs[0].numpy()
    assert got.shape == want.shape == (2, N)
    assert got.dtype == want.dtype == np.int32
    for i in range(2):
        f_got = np.bincount(got[i], minlength=4) / N
        f_want = np.bincount(want[i], minlength=4) / N
        se = np.sqrt(2 * data[i] * (1 - data[i]) / N)
        assert np.all(np.abs(f_got - f_want) <= 5 * se), (f_got, f_want)
    one, _, _ = treg.invoke_raw("_sample_multinomial",
                                (torch.from_numpy(p),), {})
    assert one[0].shape == ()


def test_sample_op_gradients_follow_the_jax_formulas():
    """``mu + z * sigma``, ``low + u * (high - low)`` and ``beta *
    gamma(alpha)``: the parameters' gradients from the draws, and the
    gamma draw's reparameterization gradient equal to JAX's
    ``random_gamma_grad`` at the same (alpha, sample) within 1e-3
    relative (torch and JAX approximate d sample / d alpha by different
    series: over 20,000 pairs they differ by 2e-5 relative at the
    median and 6e-4 at most)."""
    tmx.random.seed(7)
    mu = torch.tensor([0.5, -1.0], requires_grad=True)
    sigma = torch.tensor([2.0, 0.5], requires_grad=True)
    out = treg.get("_sample_normal").forward(mu, sigma, shape=(5,))
    out.sum().backward()
    z = (out.detach() - mu.detach()[:, None]) / sigma.detach()[:, None]
    np.testing.assert_allclose(mu.grad.numpy(), [5.0, 5.0])
    np.testing.assert_allclose(sigma.grad.numpy(), z.sum(1).numpy(), **GRAD)
    lo = torch.tensor([-1.0], requires_grad=True)
    hi = torch.tensor([3.0], requires_grad=True)
    out = treg.get("_sample_uniform").forward(lo, hi, shape=(6,))
    out.sum().backward()
    u = (out.detach() + 1.0) / 4.0
    np.testing.assert_allclose(hi.grad.numpy(), u.sum().reshape(1), **GRAD)
    np.testing.assert_allclose(lo.grad.numpy(), (6 - u.sum()).reshape(1),
                               **GRAD)
    alpha = torch.tensor([0.7, 2.5], requires_grad=True)
    beta = torch.tensor([1.5, 2.0], requires_grad=True)
    out = treg.get("_sample_gamma").forward(alpha, beta, shape=(4,))
    out.sum().backward()
    g = out.detach() / beta.detach()[:, None]
    np.testing.assert_allclose(beta.grad.numpy(), g.sum(1).numpy(), **GRAD)
    dg = np.asarray(jax.lax.random_gamma_grad(
        jnp.asarray(np.repeat(alpha.detach().numpy()[:, None], 4, 1)),
        jnp.asarray(g.numpy())))
    np.testing.assert_allclose(
        alpha.grad.numpy(), (beta.detach().numpy()[:, None] * dg).sum(1),
        rtol=1e-3)


# -- the pdf ops ----------------------------------------------------------------------


def _pos(*shape, seed=0, lo=0.2, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


PDF_CASES = [
    ("_random_pdf_uniform", lambda: [_pos(2, 3, lo=0.4, hi=0.6),
                                     _pos(2, seed=1, lo=0.0, hi=0.3),
                                     _pos(2, seed=2, lo=0.7, hi=1.0)]),
    ("_random_pdf_normal", lambda: [_pos(2, 3), _pos(2, seed=1),
                                    _pos(2, seed=2)]),
    ("_random_pdf_gamma", lambda: [_pos(2, 3), _pos(2, seed=1),
                                   _pos(2, seed=2)]),
    ("_random_pdf_exponential", lambda: [_pos(2, 3), _pos(2, seed=1)]),
    ("_random_pdf_poisson", lambda: [np.array([[0, 1, 3], [2, 5, 0]],
                                              np.float32),
                                     _pos(2, seed=1)]),
    ("_random_pdf_negative_binomial", lambda: [
        np.array([[0, 1, 3], [2, 5, 0]], np.float32), _pos(2, seed=1),
        _pos(2, seed=2, lo=0.2, hi=0.8)]),
    ("_random_pdf_generalized_negative_binomial", lambda: [
        np.array([[0, 1, 3], [2, 5, 0]], np.float32), _pos(2, seed=1),
        _pos(2, seed=2)]),
    ("_random_pdf_dirichlet", lambda: [
        (lambda s: s / s.sum(-1, keepdims=True))(_pos(2, 3, 4)),
        _pos(2, 4, seed=1)]),
]


@pytest.mark.parametrize("is_log", [False, True])
@pytest.mark.parametrize("name,make", PDF_CASES, ids=[c[0] for c in PDF_CASES])
def test_pdf_ops_match_jax(name, make, is_log):
    inputs = make()
    diff = tuple(range(len(inputs)))
    fwd = jreg.get(name).forward
    args = [jnp.asarray(x) for x in inputs]
    want, vjp = jax.vjp(lambda *a: fwd(*a, is_log=is_log), *args)
    head = np.random.RandomState(9).standard_normal(want.shape) \
        .astype(np.float32)
    want_g = vjp(jnp.asarray(head))
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    got = treg.get(name).forward(*ts, is_log=is_log)
    got.backward(torch.from_numpy(head))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    for i in diff:
        # an input the density does not read gets no gradient (the
        # uniform's sample): JAX's vjp gives zeros there
        g = ts[i].grad
        g = np.zeros(inputs[i].shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want_g[i]), **GRAD)


# -- mx.random.seed, nd.random, bulking, Dropout ---------------------------------------


def _sequence():
    ctx = tmx.cpu()
    return [tmx.nd.random.normal(0, 1, shape=(4,), ctx=ctx).asnumpy(),
            tmx.nd.random.uniform(-1, 1, shape=(3,), ctx=ctx).asnumpy(),
            tmx.nd.random.randint(0, 100, shape=(5,), ctx=ctx).asnumpy(),
            tmx.nd.random.gamma(2.0, 1.0, shape=(3,), ctx=ctx).asnumpy(),
            tmx.nd.random.poisson(3.0, shape=(3,), ctx=ctx).asnumpy()]


def test_seed_reproduces_draws_bitwise():
    tmx.random.seed(11)
    a = _sequence()
    tmx.random.seed(11, ctx="all")
    b = _sequence()
    tmx.random.seed(12)
    c = _sequence()
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_nd_random_dispatch_matches_jax():
    """The namespace's names, defaults (shape (1,), float32, int32 for
    randint) and the dispatch on NDArray parameters are the JAX
    package's; ``mx.random`` exposes ``seed``."""
    for name in ("uniform", "normal", "randn", "gamma", "exponential",
                 "poisson", "negative_binomial", "randint", "multinomial",
                 "shuffle", "bernoulli"):
        assert hasattr(tmx.nd.random, name) and hasattr(jmx.nd.random, name)
    assert callable(tmx.random.seed)
    ctx = tmx.cpu()
    for name, args in (("uniform", ()), ("normal", ()), ("gamma", ()),
                       ("exponential", ()), ("poisson", ()),
                       ("negative_binomial", ()), ("bernoulli", ()),
                       ("randint", (0, 5))):
        got = getattr(tmx.nd.random, name)(*args, ctx=ctx)
        want = getattr(jmx.nd.random, name)(*args)
        assert got.shape == want.shape == (1,), name
        assert str(got.dtype) == str(want.dtype), name
    assert tmx.nd.random.randn(2, 3, ctx=ctx).shape == (2, 3)
    lo = tmx.nd.array([0.0, 10.0], ctx=ctx)
    hi = tmx.nd.array([1.0, 11.0], ctx=ctx)
    got = tmx.nd.random.uniform(lo, hi).asnumpy()
    assert got.shape == (2,) and 0 <= got[0] < 1 and 10 <= got[1] < 11
    got = tmx.nd.random.normal(lo, tmx.nd.array([0.0, 0.0], ctx=ctx))
    np.testing.assert_array_equal(got.asnumpy(), [0.0, 10.0])
    # every sampler alias reaches its op, as in the JAX package
    for alias in ("uniform", "random_uniform", "normal", "random_normal",
                  "gamma_sample", "random_gamma", "random_exponential",
                  "random_poisson", "random_randint", "bernoulli",
                  "sample_uniform", "sample_normal", "sample_gamma",
                  "sample_multinomial", "shuffle"):
        assert treg.get(alias).name == jreg.get(alias).name


def test_samplers_flush_the_bulk_segment_and_keep_program_order():
    """A sampler between two bulked ops flushes the open segment
    (``needs_rng``) and runs eagerly, as in the JAX package; the result
    is the eager program's, bitwise."""
    ctx = tmx.cpu()
    x = tmx.nd.array(np.arange(6, dtype=np.float32), ctx=ctx)
    eng = engine.Engine.get()
    eng.flush_bulk("test")
    results = []
    for bulk in (16, 0):
        tmx.random.seed(3)
        with engine.bulk(bulk):
            a = x * 2.0 + 1.0
            pushed = eng.stats.ops_pushed
            r = tmx.nd.random.normal(0, 1, shape=(6,), ctx=ctx)
            flushed = eng.stats.ops_pushed - pushed
            b = (a * r) - a
        results.append((b.asnumpy(), r.asnumpy(), flushed))
    (bulked, r1, f1), (eager, r2, _) = results
    assert f1 >= 2, "the segment did not flush before the sampler"
    assert np.array_equal(r1, r2)
    assert np.array_equal(bulked, eager)
    a = np.arange(6, dtype=np.float32) * np.float32(2) + np.float32(1)
    np.testing.assert_array_equal(bulked, a * r1 - a)


def test_hybridized_dropout_masks_differ_and_repeat_after_seed():
    """Successive calls of a hybridized block with ``Dropout`` draw new
    masks; reseeding gives the same sequence again (on the host the
    calls run eagerly; the card's replays are checked in
    ``test_torch_kernels_cuda.py``)."""
    net = nn.HybridSequential()
    net.add(nn.Dropout(0.5))
    net.hybridize()
    x = torch.ones(64, 32)

    def masks():
        with tautograd.train_mode():
            return [net(x).clone() for _ in range(3)]
    tmx.random.seed(21)
    a = masks()
    tmx.random.seed(21)
    b = masks()
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    assert all(torch.equal(p, q) for p, q in zip(a, b))
