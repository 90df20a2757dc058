"""``mx.np.linalg`` (the port's counterpart of the JAX package's
``numpy/linalg.py``; reference: ``python/mxnet/numpy/linalg.py``).

``cholesky``, ``solve``, ``svd``, ``pinv``, ``tensorinv`` and
``tensorsolve`` call their ``_npi_*`` ops; the rest are
``torch.linalg`` closures through ``registry.invoke_fn``.  All of them
are differentiable inside ``autograd.record()``.  The signs of
``svd``'s, ``eigh``'s and ``qr``'s factors are LAPACK's (cuSOLVER's on
the card), as free as the JAX package's.
"""
from __future__ import annotations

import torch

from . import _invoke, _op, ndarray, array  # noqa: F401
from ..ndarray.ndarray import NDArray  # noqa: F401


def norm(x, ord=None, axis=None, keepdims=False):
    dim = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return _invoke(lambda a: torch.linalg.norm(
        a if a.is_floating_point() else a.to(torch.float32), ord=ord,
        dim=dim, keepdim=keepdims), [x], "_np_linalg_norm")


def inv(a):
    return _invoke(torch.linalg.inv, [a], "_np_linalg_inv")


def det(a):
    return _invoke(torch.linalg.det, [a], "_np_linalg_det")


def slogdet(a):
    return tuple(_invoke(lambda x: tuple(torch.linalg.slogdet(x)), [a],
                         "_np_linalg_slogdet", None))


def cholesky(a):
    return _op("_npi_cholesky", [a])


def svd(a):
    """``(u, s, vt)``, the reduced factors."""
    return tuple(_op("_npi_svd", [a]))


def eigh(a):
    return tuple(_invoke(lambda x: tuple(torch.linalg.eigh(x)), [a],
                         "_np_linalg_eigh", None))


def eigvalsh(a):
    return _invoke(torch.linalg.eigvalsh, [a], "_np_linalg_eigvalsh")


def solve(a, b):
    return _op("_npi_solve", [a, b])


def _svd_cutoff(s, m, n, rcond):
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    return rcond * s.max()


def lstsq(a, b, rcond=None):
    """``(x, residuals, rank, s)`` as ``jnp.linalg.lstsq`` gives them,
    through the pseudo-inverse (cuSOLVER's least squares takes full rank
    only)."""
    def fn(x, y):
        m, n = x.shape[-2:]
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        keep = s > _svd_cutoff(s, m, n, rcond)
        s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0),
                            torch.zeros_like(s))
        uty = u.transpose(-2, -1) @ (y if y.dim() > 1 else y[:, None])
        sol = vt.transpose(-2, -1) @ (s_inv[:, None] * uty)
        rank = keep.sum().to(torch.int32)
        resid = ((y if y.dim() > 1 else y[:, None]) - x @ sol) ** 2
        full_rank = bool(m > n) and int(rank) == n
        res = resid.sum(0) if full_rank else torch.zeros(
            (0,), dtype=x.dtype, device=x.device)
        if y.dim() == 1:
            sol = sol[:, 0]
        return sol, res, rank, s
    return tuple(_invoke(fn, [a, b], "_np_linalg_lstsq", None))


def pinv(a, rcond=1e-15):
    return _op("_npi_pinv_scalar_rcond", [a], {"rcond": rcond})


def matrix_rank(a, tol=None):
    def fn(x):
        s = torch.linalg.svdvals(x)
        cut = tol if tol is not None else \
            s.max(-1, keepdim=True).values * max(x.shape[-2:]) \
            * torch.finfo(s.dtype).eps
        return (s > cut).sum(-1).to(torch.int32)
    return _invoke(fn, [a], "_np_linalg_matrix_rank")


def qr(a):
    return tuple(_invoke(lambda x: tuple(torch.linalg.qr(x)), [a],
                         "_np_linalg_qr", None))


def tensorinv(a, ind=2):
    return _op("_npi_tensorinv", [a], {"ind": ind})


def tensorsolve(a, b, axes=None):
    if axes is None:
        return _op("_npi_tensorsolve", [a, b])
    return _invoke(lambda x, y: torch.linalg.tensorsolve(x, y, dims=axes),
                   [a, b], "_np_linalg_tensorsolve")
