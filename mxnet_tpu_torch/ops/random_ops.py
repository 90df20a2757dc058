"""Random sampling operators (the port's counterpart of the JAX
package's ``ops/random_ops.py``; reference: ``src/operator/random/``).

Every sampler draws from torch's default generator for the device it
makes its output on, which ``mx.random.seed`` reseeds (the host's and
every card's); on the card that is a Philox stream whose offset CUDA
graphs advance at each replay, so a sampler inside a captured graph
draws afresh at every replay.  The JAX package draws from threefry keys
instead: the two are compared by moments, never by value.  The
samplers are ``needs_rng`` ops, so bulking never defers them: an open
bulk segment flushes first and program order holds.

Each sampler keeps the JAX package's formula where it has one
(``loc + scale * z``, ``low + u * (high - low)``, ``beta * gamma(alpha)``,
a gamma then a Poisson draw for the negative binomial), so gradients
with respect to the ``_sample_*`` parameter arrays follow the same
formulas (the gamma draw's through torch's implicit reparameterization,
as ``jax.random.gamma``'s).  ``_sample_multinomial`` is the Gumbel-max
draw of ``jax.random.categorical`` over ``log(max(p, 1e-30))`` and
ignores ``get_prob``, as the JAX package does.

The ``_random_pdf_*`` ops give the density (``is_log``: the log-density)
of ``sample`` under parameters whose shape is the leftmost part of the
sample's; their gradients come from torch's autograd, as the JAX
package's come from its tape.
"""
from __future__ import annotations

import math

import torch

from .registry import register
from .tensor import to_torch_dtype


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _empty(shape, dtype, device):
    return torch.empty(_shape(shape), dtype=to_torch_dtype(dtype),
                       device=device)


def _standard_gamma(alpha, shape, device):
    """Gamma(alpha, 1) draws of ``shape`` in f32 (``alpha`` a number or a
    tensor broadcast to ``shape``)."""
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.full((), float(alpha), dtype=torch.float32,
                           device=device)
    a = alpha.to(torch.float32).expand(shape).contiguous()
    return torch._standard_gamma(a)


def _tiny_uniform(shape, dtype, device):
    """Uniform draws in ``[tiny, 1)``, which a log can take."""
    tiny = torch.finfo(dtype).tiny
    return torch.empty(shape, dtype=dtype, device=device).uniform_(tiny, 1.0)


@register("_random_uniform", aliases=("uniform", "random_uniform"),
          needs_rng=True)
def _random_uniform(low=0.0, high=1.0, shape=(), dtype="float32",
                    device=None):
    return _empty(shape, dtype, device).uniform_(low, high)


@register("_random_normal", aliases=("normal", "random_normal"),
          needs_rng=True)
def _random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32",
                   device=None):
    return loc + scale * _empty(shape, dtype, device).normal_()


@register("_random_gamma", aliases=("gamma_sample", "random_gamma"),
          needs_rng=True)
def _random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32",
                  device=None):
    g = _standard_gamma(alpha, _shape(shape), device)
    return (beta * g).to(to_torch_dtype(dtype))


@register("_random_exponential", aliases=("random_exponential",),
          needs_rng=True)
def _random_exponential(lam=1.0, shape=(), dtype="float32", device=None):
    return _empty(shape, dtype, device).exponential_() / lam


@register("_random_poisson", aliases=("random_poisson",), needs_rng=True)
def _random_poisson(lam=1.0, shape=(), dtype="float32", device=None):
    rate = torch.full(_shape(shape), float(lam), dtype=torch.float32,
                      device=device)
    return torch.poisson(rate).to(to_torch_dtype(dtype))


@register("_random_negative_binomial", needs_rng=True)
def _random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                              device=None):
    """Failures before the ``k``-th success at success probability
    ``p``: a Poisson draw at a Gamma(k) * (1 - p) / p rate."""
    lam = _standard_gamma(k, _shape(shape), device) * (1.0 - p) / p
    return torch.poisson(lam).to(to_torch_dtype(dtype))


@register("_random_randint", aliases=("random_randint",), needs_rng=True)
def _random_randint(low=0, high=1, shape=(), dtype="int32", device=None):
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=to_torch_dtype(dtype), device=device)


@register("_random_bernoulli", aliases=("bernoulli",), needs_rng=True)
def _random_bernoulli(prob=0.5, shape=(), dtype="float32", device=None):
    u = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    return (u.uniform_() < prob).to(to_torch_dtype(dtype))


@register("_random_gumbel", needs_rng=True)
def _random_gumbel(loc=0.0, scale=1.0, shape=(), dtype="float32",
                   device=None):
    u = _tiny_uniform(_shape(shape), to_torch_dtype(dtype), device)
    return loc + scale * -torch.log(-torch.log(u))


# _sample_* : per-element distribution parameters given as input arrays
# (reference multisample_op.cc): the output is param.shape + shape


def _param(x, extra, dtype):
    return x.reshape(tuple(x.shape) + (1,) * extra).to(dtype)


@register("_sample_uniform", aliases=("sample_uniform",), needs_rng=True)
def _sample_uniform(low, high, shape=(), dtype="float32"):
    s, dt = _shape(shape), to_torch_dtype(dtype)
    u = torch.empty(tuple(low.shape) + s, dtype=dt,
                    device=low.device).uniform_()
    low_b, high_b = _param(low, len(s), dt), _param(high, len(s), dt)
    return low_b + u * (high_b - low_b)


@register("_sample_normal", aliases=("sample_normal",), needs_rng=True)
def _sample_normal(mu, sigma, shape=(), dtype="float32"):
    s, dt = _shape(shape), to_torch_dtype(dtype)
    z = torch.empty(tuple(mu.shape) + s, dtype=dt,
                    device=mu.device).normal_()
    return _param(mu, len(s), dt) + z * _param(sigma, len(s), dt)


@register("_sample_gamma", aliases=("sample_gamma",), needs_rng=True)
def _sample_gamma(alpha, beta, shape=(), dtype="float32"):
    s, dt = _shape(shape), to_torch_dtype(dtype)
    out_shape = tuple(alpha.shape) + s
    g = _standard_gamma(_param(alpha, len(s), dt), out_shape, alpha.device)
    return g.to(dt) * _param(beta, len(s), dt)


@register("_sample_multinomial", aliases=("sample_multinomial",),
          needs_rng=True)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """``data`` (..., K) probabilities: ``shape`` class indices drawn per
    row (one where ``shape`` is empty)."""
    s = _shape(shape)
    n = max(math.prod(s), 1)
    logits = torch.log(torch.clamp(data.float(), min=1e-30))
    flat = logits.reshape(-1, logits.shape[-1])
    u = _tiny_uniform((flat.shape[0], n, flat.shape[1]), torch.float32,
                      data.device)
    samp = torch.argmax(flat[:, None, :] - torch.log(-torch.log(u)), -1)
    return samp.reshape(tuple(data.shape[:-1]) + s).to(
        to_torch_dtype(dtype))


@register("_shuffle", aliases=("shuffle",), needs_rng=True)
def _shuffle(data):
    """A random permutation of axis 0."""
    return data[torch.randperm(data.shape[0], device=data.device)]


# ----------------------------------------------------------------------------
# _random_pdf_*: the density of ``sample`` under per-element parameters
# (reference pdf_op.cc, functors in pdf_op.h); the parameters broadcast
# over the sample's trailing axes.
# ----------------------------------------------------------------------------


def _bcast(param, ndim):
    return param.reshape(tuple(param.shape) + (1,) * (ndim - param.dim()))


def _out(lpdf, is_log):
    return lpdf if is_log else torch.exp(lpdf)


@register("_random_pdf_uniform", aliases=("random_pdf_uniform",))
def _random_pdf_uniform(sample, low, high, is_log=False):
    lo, hi = _bcast(low, sample.dim()), _bcast(high, sample.dim())
    return _out((-torch.log(hi - lo)).expand(sample.shape), is_log)


@register("_random_pdf_normal", aliases=("random_pdf_normal",))
def _random_pdf_normal(sample, mu, sigma, is_log=False):
    u, s = _bcast(mu, sample.dim()), _bcast(sigma, sample.dim())
    lpdf = (-0.5 * torch.square(sample - u) / torch.square(s)
            - torch.log(math.sqrt(2.0 * math.pi) * s))
    return _out(lpdf, is_log)


@register("_random_pdf_gamma", aliases=("random_pdf_gamma",))
def _random_pdf_gamma(sample, alpha, beta, is_log=False):
    a, b = _bcast(alpha, sample.dim()), _bcast(beta, sample.dim())
    lpdf = (a * torch.log(b) + (a - 1.0) * torch.log(sample) - b * sample
            - torch.lgamma(a))
    return _out(lpdf, is_log)


@register("_random_pdf_exponential", aliases=("random_pdf_exponential",))
def _random_pdf_exponential(sample, lam, is_log=False):
    rate = _bcast(lam, sample.dim())
    return _out(torch.log(rate) - rate * sample, is_log)


@register("_random_pdf_poisson", aliases=("random_pdf_poisson",))
def _random_pdf_poisson(sample, lam, is_log=False):
    rate = _bcast(lam, sample.dim())
    lpdf = sample * torch.log(rate) - torch.lgamma(sample + 1.0) - rate
    return _out(lpdf, is_log)


def _nb_lpdf(limit, prob, x):
    """log NB(x; limit, prob), ``prob`` the failure probability
    (pdf_op.h PDF_NegativeBinomial::LPDF)."""
    return (torch.lgamma(x + limit) - torch.lgamma(x + 1.0)
            - torch.lgamma(limit) + limit * torch.log(prob)
            + x * torch.log(1.0 - prob))


@register("_random_pdf_negative_binomial",
          aliases=("random_pdf_negative_binomial",))
def _random_pdf_negative_binomial(sample, k, p, is_log=False):
    return _out(_nb_lpdf(_bcast(k, sample.dim()), _bcast(p, sample.dim()),
                         sample), is_log)


@register("_random_pdf_generalized_negative_binomial",
          aliases=("random_pdf_generalized_negative_binomial",))
def _random_pdf_generalized_negative_binomial(sample, mu, alpha,
                                              is_log=False):
    m, a = _bcast(mu, sample.dim()), _bcast(alpha, sample.dim())
    return _out(_nb_lpdf(1.0 / a, 1.0 / (m * a + 1.0), sample), is_log)


@register("_random_pdf_dirichlet", aliases=("random_pdf_dirichlet",))
def _random_pdf_dirichlet(sample, alpha, is_log=False):
    """``alpha`` (s..., k), ``sample`` (s..., m..., k) → (s..., m...)."""
    a = alpha.reshape(tuple(alpha.shape[:-1])
                      + (1,) * (sample.dim() - alpha.dim())
                      + tuple(alpha.shape[-1:]))
    lpdf = (torch.sum((a - 1.0) * torch.log(sample), -1)
            + torch.lgamma(torch.sum(a, -1))
            - torch.sum(torch.lgamma(a), -1))
    return _out(lpdf, is_log)
