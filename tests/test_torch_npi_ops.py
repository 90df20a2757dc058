"""The port's ``ops/npi.py`` against the JAX package's, on the CPU.

Every op the JAX package's ``ops/npi.py`` registers runs through both
packages' registered forwards (``check_op``) on the same seeded numpy
inputs, at its defaults and with at least one attribute away from its
default (where it has attributes): outputs' shapes and dtypes equal,
integer, ordering and indexing results bitwise, f32 arithmetic within
rtol 1e-5 / atol 1e-6 (the linear algebra within rtol 1e-3 / atol 1e-4),
and, for the differentiable ops listed in ``_GRADS``, gradients against
``jax.vjp`` of the JAX op within rtol 1e-4 / atol 1e-5.  The ops that
read the host (``_npi_bincount``, ``_npi_unique``, ``_npx_nonzero``,
``_npi_delete``, the set ops) run through both registries' ``invoke``,
bitwise.  The samplers are held by moments: mean and variance within 5
standard errors of the distribution's.  A test holds the table itself
to the JAX module's op names, aliases included.
"""
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ndarray  # noqa: F401  (registers every JAX op)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from test_torch_ops_tensor import EXACT, LINALG, REPO, check_op


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


X = _f32(3, 4)
P = np.abs(_f32(3, 4, seed=1)) + 0.5
X3 = _f32(2, 3, 4, seed=2)
V = _f32(5, seed=3)
V4 = np.sort(_f32(4, seed=4))
I = np.random.RandomState(5).randint(-5, 6, (3, 4)).astype(np.int32)
IP = np.random.RandomState(6).randint(1, 10, (3, 4)).astype(np.int32)
B = X > 0
X0 = np.array(1.5, np.float32)
X11 = _f32(1, 1, seed=7)
SPD = (lambda a: (a @ a.T + 3 * np.eye(3)).astype(np.float32))(
    _f32(3, 3, seed=8))
NANX = X.copy()
NANX[0, 1] = NANX[2, 3] = np.nan
INFX = np.array([[1.0, np.nan, np.inf], [-np.inf, 2.0, -0.0]], np.float32)
A3 = _f32(3, 4, seed=9)
B3 = _f32(3, 4, seed=10)

# (op, inputs, attrs): the first entry of an op is its defaults where the
# defaults make a valid call
CASES = [
    ("_np_all", [B], {}), ("_np_all", [B], {"axis": 1, "keepdims": True}),
    ("_np_any", [B], {}), ("_np_any", [B], {"axis": 0}),
    ("_np_sum", [X], {}), ("_np_sum", [X], {"axis": (0, 1),
                                            "keepdims": True}),
    ("_np_sum", [I], {"axis": 1}), ("_np_sum", [B], {}),
    ("_np_max", [X], {}), ("_np_max", [X], {"axis": 0}),
    ("_np_min", [X], {}), ("_np_min", [X], {"axis": -1, "keepdims": True}),
    ("_np_prod", [P], {}), ("_np_prod", [P], {"axis": 1}),
    ("_np_prod", [IP], {"axis": 0}),
    ("_npi_mean", [X], {}), ("_npi_mean", [X], {"axis": 0,
                                                "keepdims": True}),
    ("_npi_mean", [I], {}),
    ("_npi_std", [X], {}), ("_npi_std", [X], {"axis": 1, "ddof": 1}),
    ("_npi_var", [X], {}), ("_npi_var", [X], {"axis": 0, "ddof": 1,
                                              "keepdims": True}),
    ("_np_cumsum", [X], {}), ("_np_cumsum", [X], {"axis": 1}),
    ("_np_cumsum", [I], {"axis": 0}), ("_np_cumsum", [B], {}),
    ("_np_copy", [X], {}),
    ("_np_reshape", [X11], {}), ("_np_reshape", [X], {"newshape": (4, 3)}),
    ("_npx_reshape", [X11], {}),
    ("_npx_reshape", [X], {"newshape": (2, -1)}),
    ("_np_squeeze", [X3[:1, :, :1]], {}),
    ("_np_squeeze", [X3[:1, :, :1]], {"axis": 0}),
    ("_np_transpose", [X3], {}),
    ("_np_transpose", [X3], {"axes": (2, 0, 1)}),
    ("_np_moveaxis", [X3], {}),
    ("_np_moveaxis", [X3], {"source": 0, "destination": 2}),
    ("_np_roll", [X], {}), ("_np_roll", [X], {"shift": 1, "axis": 1}),
    ("_np_roll", [X], {"shift": 5}),
    ("_npi_rot90", [X], {}), ("_npi_rot90", [X], {"k": 3}),
    ("_npi_flip", [X], {}), ("_npi_flip", [X], {"axis": 1}),
    ("_np_diag", [V], {}), ("_np_diag", [V], {"k": 1}),
    ("_np_diag", [X], {"k": -1}),
    ("_np_diagflat", [V], {}), ("_np_diagflat", [X], {"k": -1}),
    ("_np_diagonal", [X], {}), ("_np_diagonal", [X3], {"offset": 1,
                                                       "axis1": 1,
                                                       "axis2": 2}),
    ("_np_trace", [X], {}), ("_np_trace", [X], {"offset": -1}),
    ("_np_trace", [IP], {}),
    ("_npi_tril", [X], {}), ("_npi_tril", [X], {"k": -1}),
    ("_np_dot", [X, X.T.copy()], {}), ("_np_dot", [V, V], {}),
    ("_np_dot", [X3, _f32(4, 2)], {}), ("_np_dot", [X, V4], {}),
    ("_npi_broadcast_to", [X0], {}),
    ("_npi_broadcast_to", [V[None]], {"shape": (3, 5)}),
    ("_npi_share_memory", [X, X], {}),
    ("_np_atleast_1d", [X0, V], {}), ("_np_atleast_2d", [X0, V], {}),
    ("_np_atleast_3d", [V, X], {}),
    ("_npi_bitwise_not", [I], {}),
    ("_npi_true_divide", [X, P], {}), ("_npi_true_divide", [I, IP], {}),
    ("_npi_true_divide_scalar", [X], {}),
    ("_npi_true_divide_scalar", [X], {"scalar": 3.0}),
    ("_npi_true_divide_scalar", [I], {"scalar": 2}),
    ("_npi_rtrue_divide_scalar", [P], {}),
    ("_npi_rtrue_divide_scalar", [IP], {"scalar": 2.0}),
    ("_npi_hypot", [X, P], {}), ("_npi_log", [P], {}),
    ("_npi_logical_not", [B], {}), ("_npi_logical_not", [X], {}),
    ("_npi_deg2rad", [X], {}), ("_npi_rad2deg", [X], {}),
    ("_npi_around", [X * 10], {}), ("_npi_around", [X], {"decimals": 1}),
    ("_npi_nan_to_num", [INFX], {}),
    ("_npi_nan_to_num", [INFX], {"nan": 1.0, "posinf": 9.0,
                                 "neginf": -9.0}),
    ("_npi_backward_nan_to_num", [INFX], {"nan": -2.0}),
    ("_npx_relu", [X], {}), ("_npx_sigmoid", [X], {}),
    ("_npx_constraint_check", [B], {}),
    ("_npx_constraint_check", [np.ones(3, bool)], {"msg": "bad"}),
    ("_npi_argmax", [X], {}), ("_npi_argmax", [X], {"axis": 1,
                                                    "keepdims": True}),
    ("_npi_argmin", [X], {}), ("_npi_argmin", [X], {"axis": 0}),
    ("_npi_average", [X], {}), ("_npi_average", [X], {"axis": 1}),
    ("_npi_average", [X, P], {"axis": 0}),
    ("_npi_diff", [X], {}), ("_npi_diff", [X], {"n": 2, "axis": 0}),
    ("_npi_blackman", [], {}), ("_npi_blackman", [], {"M": 7}),
    ("_npi_hamming", [], {}), ("_npi_hamming", [], {"M": 7}),
    ("_npi_hanning", [], {}), ("_npi_hanning", [], {"M": 7}),
    ("_npi_bartlett", [], {}), ("_npi_bartlett", [], {"M": 6}),
    ("_npi_zeros", [], {}), ("_npi_zeros", [], {"shape": (2, 3),
                                                "dtype": "int32"}),
    ("_npi_ones", [], {}), ("_npi_ones", [], {"shape": (2, 3),
                                              "dtype": "bool"}),
    ("_npi_identity", [], {"shape": (3,)}),
    ("_npi_identity", [], {"shape": 4, "dtype": "int32"}),
    ("_npi_eye", [], {}), ("_npi_eye", [], {"N": 3, "M": 4, "k": 1}),
    ("_npi_eye", [], {"N": 4, "M": 2, "k": -1}),
    ("_npi_arange", [], {}), ("_npi_arange", [], {"start": 2.0,
                                                  "stop": 11.0,
                                                  "step": 1.5}),
    ("_npi_arange", [], {"start": 5, "dtype": "int32"}),
    ("_npi_logspace", [], {}),
    ("_npi_logspace", [], {"start": 1.0, "stop": 3.0, "num": 5,
                           "endpoint": False, "base": 2.0}),
    ("_npi_indices", [], {"dimensions": (2, 3)}),
    ("_npi_indices", [], {"dimensions": (3,), "dtype": "float32"}),
    ("_npi_full_like", [X], {}),
    ("_npi_full_like", [X], {"fill_value": 2.5, "dtype": "int32"}),
    ("_npi_concatenate", [X, P], {}),
    ("_npi_concatenate", [X, P], {"axis": 1}),
    ("_npi_stack", [X, P], {}), ("_npi_stack", [X, P], {"axis": 2}),
    ("_npi_vstack", [V, V], {}), ("_npi_vstack", [X, P], {}),
    ("_npi_hstack", [V, V], {}), ("_npi_hstack", [X, P], {}),
    ("_npi_dstack", [V, V], {}), ("_npi_dstack", [X, P], {}),
    ("_npi_column_stack", [V, V], {}), ("_npi_column_stack", [X, P], {}),
    ("_npi_hsplit", [X], {"sections": 2}),
    ("_npi_hsplit", [X], {"indices": (1, 3)}),
    ("_npi_hsplit_backward", [V4], {"sections": 2}),
    ("_npi_where", [B, X, P], {}),
    ("_npi_boolean_mask_assign_scalar", [X, B], {}),
    ("_npi_boolean_mask_assign_scalar", [X, B], {"value": 2.0}),
    ("_npi_boolean_mask_assign_tensor", [X, B, P], {}),
    ("_npi_cholesky", [SPD], {}), ("_npi_solve", [SPD, V[:3]], {}),
    ("_npi_solve", [SPD, X[:, :3].copy()], {}),
    ("_npi_pinv", [X], {}), ("_npi_pinv", [X], {"rcond": 0.1}),
    ("_npi_pinv_scalar_rcond", [X], {}),
    ("_npi_pinv_scalar_rcond", [X], {"rcond": 0.1}),
    ("_npi_tensorinv", [np.eye(4, dtype=np.float32).reshape(2, 2, 4) * 2],
     {}),
    ("_npi_tensorinv", [np.eye(4, dtype=np.float32).reshape(4, 2, 2) + 1],
     {"ind": 1}),
    ("_npi_tensorsolve", [SPD.reshape(3, 3), V[:3]], {}),
    ("_npi_tensorsolve", [SPD, V[:3]], {"a_axes": (0,)}),
    ("_npi_tensordot", [V[:2], V[:3]], {}),
    ("_npi_tensordot", [X, X3], {"a_axes_summed": (1,),
                                 "b_axes_summed": (2,)}),
    ("_npi_tensordot_int_axes", [X, P], {}),
    ("_npi_tensordot_int_axes", [X, P.T.copy()], {"axes": 1}),
    ("_npi_percentile", [X], {}),
    ("_npi_percentile", [X], {"q": 30.0, "axis": 1,
                              "interpolation": "lower", "keepdims": True}),
    ("_npi_percentile", [X], {"q": (10.0, 90.0), "axis": 0,
                              "interpolation": "nearest"}),
    ("_npi_quantile", [X], {}),
    ("_npi_quantile", [X], {"q": 0.3, "axis": 0,
                            "interpolation": "midpoint"}),
    ("_npi_quantile", [X], {"q": 0.7, "interpolation": "higher"}),
    ("_npi_median", [X], {}), ("_npi_median", [X], {"axis": 1,
                                                    "keepdims": True}),
    ("_npi_histogram", [X], {}),
    ("_npi_histogram", [X], {"bin_cnt": 4, "range": (-1.0, 1.0)}),
    ("_npi_cov", [X], {}), ("_npi_cov", [X], {"rowvar": False, "ddof": 2}),
    ("_npi_cov", [X], {"bias": True}),
    ("_npi_corrcoef", [X], {}), ("_npi_corrcoef", [X], {"rowvar": False}),
    ("_npi_ptp", [X], {}), ("_npi_ptp", [X], {"axis": 1, "keepdims": True}),
    ("_npi_nanmean", [NANX], {}),
    ("_npi_nanmean", [NANX], {"axis": 1, "keepdims": True}),
    ("_npi_nanstd", [NANX], {}), ("_npi_nanstd", [NANX], {"axis": 0,
                                                          "ddof": 1}),
    ("_npi_nanvar", [NANX], {}), ("_npi_nanvar", [NANX], {"axis": 1,
                                                          "ddof": 1}),
    ("_npi_nanmax", [NANX], {}), ("_npi_nanmax", [NANX], {"axis": 0}),
    ("_npi_nanmin", [NANX], {}), ("_npi_nanmin", [NANX], {"axis": 1,
                                                          "keepdims": True}),
    ("_npi_nansum", [NANX], {}), ("_npi_nansum", [NANX], {"axis": 0}),
    ("_npi_nanprod", [NANX], {}), ("_npi_nanprod", [NANX], {"axis": 1}),
    ("_npi_nanargmax", [NANX], {}), ("_npi_nanargmax", [NANX], {"axis": 1}),
    ("_npi_nanargmin", [NANX], {}), ("_npi_nanargmin", [NANX], {"axis": 0}),
    ("_npi_polyval", [V[:3], X], {}),
    ("_npi_ediff1d", [X], {}), ("_npi_ediff1d", [V, V[:2], V[:1]], {}),
    ("_npi_digitize", [X, V4], {}), ("_npi_digitize", [X, V4],
                                     {"right": True}),
    ("_npi_digitize", [X, V4[::-1].copy()], {}),
    ("_npi_trapz", [X], {}), ("_npi_trapz", [X], {"dx": 0.5, "axis": 0}),
    ("_npi_trapz", [X, V4], {}),
    ("_npi_cross", [A3[:, :3], B3[:, :3]], {}),
    ("_npi_cross", [A3[:3], B3[:3]], {"axis": 0}),
    ("_npi_cross", [A3[:, :2], B3[:, :3]], {"axisc": 0}),
    ("_npi_fmod", [X, P], {}), ("_npi_heaviside", [X, P], {}),
    ("_npi_logaddexp", [X, P], {}), ("_npi_nextafter", [X, P], {}),
    ("_npi_gcd", [IP, I], {}),
    ("_npi_signbit", [X], {}), ("_npi_spacing", [X], {}),
    ("_npi_cbrt", [X], {}), ("_npi_positive", [X], {}),
    ("_npi_fabs", [X], {}), ("_npi_fabs", [I], {}),
    ("_npi_isin", [I, IP[0]], {}), ("_npi_isin", [I, IP[0]],
                                    {"invert": True}),
]
for _name, _a, _b in [("add", X, P), ("subtract", X, P),
                      ("multiply", X, P), ("mod", X, P), ("power", P, X),
                      ("copysign", X, -P), ("arctan2", X, P),
                      ("lcm", IP, I), ("bitwise_or", I, IP),
                      ("bitwise_xor", I, IP)]:
    CASES += [("_npi_" + _name, [_a, _b], {}),
              ("_npi_" + _name + "_scalar", [_a], {}),
              ("_npi_" + _name + "_scalar", [_a], {"scalar": 3})]
CASES += [("_npi_ldexp", [X, I], {}), ("_npi_ldexp_scalar", [X], {}),
          ("_npi_ldexp_scalar", [X], {"scalar": 3.0})]
for _name, _a in [("rsubtract", X), ("rmod", P), ("rpower", X),
                  ("rcopysign", X), ("rarctan2", X), ("rldexp", I)]:
    CASES += [("_npi_%s_scalar" % _name, [_a], {}),
              ("_npi_%s_scalar" % _name, [_a], {"scalar": 2.5})]

_LINALG_OPS = {"_npi_cholesky", "_npi_solve", "_npi_pinv",
               "_npi_pinv_scalar_rcond", "_npi_tensorinv",
               "_npi_tensorsolve"}
# XLA's and torch's transcendental functions, reductions and the
# 2-pass statistics round differently in the last bits
_LOOSE = {"_npi_logaddexp", "_npi_cbrt", "_npi_corrcoef", "_npi_cov",
          "_npi_nanstd", "_npi_nanvar", "_npi_std", "_npi_var",
          "_npi_logspace", "_npi_percentile", "_npi_quantile",
          "_npi_median", "_npi_arctan2", "_npi_arctan2_scalar",
          "_npi_rarctan2_scalar", "_npi_hypot"}
# exact: integers, ordering, indexing, copies and selections
_EXACT_PREFIX = ("_np_all", "_np_any", "_npi_arg", "_npi_nanarg",
                 "_npi_bitwise", "_npi_gcd", "_npi_lcm", "_npi_isin",
                 "_npi_digitize", "_npi_signbit", "_np_reshape",
                 "_npx_reshape", "_np_squeeze", "_np_transpose",
                 "_np_moveaxis", "_np_roll", "_npi_rot90", "_npi_flip",
                 "_np_diag", "_npi_tril", "_npi_concatenate", "_npi_stack",
                 "_npi_vstack", "_npi_hstack", "_npi_dstack",
                 "_npi_column_stack", "_npi_hsplit", "_npi_where",
                 "_npi_boolean_mask", "_np_atleast", "_npi_zeros",
                 "_npi_ones", "_npi_identity", "_npi_eye", "_npi_indices",
                 "_npi_full_like", "_np_copy", "_npi_broadcast_to",
                 "_npi_share_memory", "_npx_constraint_check",
                 "_npi_nan_to_num", "_npi_backward_nan_to_num",
                 "_npi_positive", "_npi_fabs", "_npx_relu")


def _tol(name):
    if name in _LINALG_OPS:
        return LINALG
    if name in _LOOSE:
        return dict(rtol=1e-5, atol=1e-5)
    if name.startswith(_EXACT_PREFIX):
        return EXACT
    return dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,inputs,attrs", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_npi_op_matches_jax(name, inputs, attrs):
    check_op(name, inputs, attrs, fwd=_tol(name))


# the differentiable ops whose gradients are held against jax.vjp
_GRADS = [
    ("_np_sum", [X], {"axis": 1}, (0,)),
    ("_npi_mean", [X], {}, (0,)),
    ("_npi_std", [X], {"axis": 0, "ddof": 1}, (0,)),
    ("_np_prod", [P], {"axis": 1}, (0,)),
    ("_np_cumsum", [X], {"axis": 0}, (0,)),
    ("_np_dot", [X, X.T.copy()], {}, (0, 1)),
    ("_np_trace", [X], {}, (0,)),
    ("_np_roll", [X], {"shift": 1, "axis": 1}, (0,)),
    ("_npi_true_divide", [X, P], {}, (0, 1)),
    ("_npi_hypot", [X, P], {}, (0, 1)),
    ("_npi_power", [P, X], {}, (0, 1)),
    ("_npi_where", [B, X, P], {}, (1, 2)),
    ("_npi_average", [X, P], {"axis": 0}, (0, 1)),
    ("_npi_percentile", [X], {"q": 30.0, "axis": 1}, (0,)),
    ("_npi_cov", [X], {}, (0,)),
    ("_npi_nanmean", [NANX], {"axis": 0}, (0,)),
    ("_npi_tensordot", [X, X3], {"a_axes_summed": (1,),
                                 "b_axes_summed": (2,)}, (0, 1)),
    ("_npi_polyval", [V[:3], X], {}, (0, 1)),
    ("_npi_trapz", [X, V4], {}, (0,)),
    ("_npi_cross", [A3[:, :3], B3[:, :3]], {}, (0, 1)),
    ("_npi_logaddexp", [X, P], {}, (0, 1)),
    ("_npi_boolean_mask_assign_tensor", [X, B, P], {}, (0, 2)),
]


@pytest.mark.parametrize("name,inputs,attrs,diff", _GRADS,
                         ids=[g[0] for g in _GRADS])
def test_npi_op_gradients_match_jax(name, inputs, attrs, diff):
    check_op(name, inputs, attrs, diff=diff, fwd=dict(rtol=1e-5, atol=1e-5))


def test_npi_cholesky_and_solve_gradients_match_jax():
    check_op("_npi_cholesky", [SPD], diff=(0,), fwd=LINALG, grad=LINALG)
    check_op("_npi_solve", [SPD, V[:3]], diff=(0, 1), fwd=LINALG,
             grad=LINALG)


def test_npi_svd_matches_jax_up_to_signs():
    """``(u, s, vt)``: ``s`` within 1e-5, the factors' absolute values
    within 1e-4, the reconstruction within 1e-5 of the input's largest."""
    got = [t.numpy() for t in treg.get("_npi_svd").forward(
        torch.from_numpy(X))]
    want = [np.asarray(t) for t in jreg.get("_npi_svd").forward(
        jnp.asarray(X))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(np.abs(g), np.abs(w), rtol=1e-4,
                                   atol=1e-5)
    u, s, vt = got
    np.testing.assert_allclose((u * s) @ vt, X, atol=1e-5 * np.abs(X).max())


# -- the ops that read the host ----------------------------------------------------

DUPS = np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0], np.float32)
HOST_CASES = [
    ("_npi_bincount", [IP.ravel()], {}),
    ("_npi_bincount", [IP.ravel()], {"minlength": 12}),
    ("_npi_bincount", [IP.ravel(), P.ravel()], {}),
    ("_npi_unique", [DUPS], {}),
    ("_npi_unique", [DUPS], {"return_index": True, "return_inverse": True,
                             "return_counts": True}),
    ("_npi_unique", [IP], {"axis": 0}),
    ("_npx_nonzero", [X > 0], {}),
    ("_npx_nonzero", [I], {}),
    ("_npi_delete", [V], {}),
    ("_npi_delete", [V], {"int_ind": 2}),
    ("_npi_delete", [X], {"start": 0, "stop": 3, "step": 2, "axis": 1}),
    ("_npi_delete", [V, np.array([0, 3], np.int32)], {}),
    ("_npi_intersect1d", [DUPS, V4.round()], {}),
    ("_npi_intersect1d", [np.array([1., 3.], np.float32),
                          np.array([3., 4.], np.float32)],
     {"assume_unique": True}),
    ("_npi_union1d", [DUPS, V4.round()], {}),
    ("_npi_union1d", [DUPS, V4.round()], {"assume_unique": True}),
    ("_npi_setdiff1d", [DUPS, np.array([1.], np.float32)], {}),
    ("_npi_setdiff1d", [np.array([1., 3.], np.float32),
                        np.array([3., 4.], np.float32)],
     {"assume_unique": True}),
    ("_npi_setxor1d", [DUPS, np.array([1., 5.], np.float32)], {}),
    ("_npi_setxor1d", [np.array([1., 3.], np.float32),
                       np.array([3., 4.], np.float32)],
     {"assume_unique": True}),
]


@pytest.mark.parametrize("name,inputs,attrs", HOST_CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(HOST_CASES)])
def test_host_read_op_matches_jax(name, inputs, attrs):
    """Through both registries' ``invoke`` (the override reads the host),
    bitwise, in the JAX package's dtypes; the port's results keep the
    first input's class."""
    want = jreg.invoke(name, [jmx.nd.array(x, dtype=x.dtype)
                              for x in inputs], dict(attrs))
    with tmx.cpu():
        got = treg.invoke(name, [tmx.np.array(x, dtype=x.dtype)
                                 for x in inputs], dict(attrs))
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is tmx.np.ndarray
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_host_read_ops_keep_64_bit_inputs_64_bit():
    with tmx.cpu():
        out = treg.invoke("_npi_bincount", [tmx.nd.array(
            np.array([0, 2, 2]), dtype="int64")])
        assert out.dtype == np.int64
        out = treg.invoke("_npx_nonzero", [tmx.nd.array(
            np.array([0, 1, 1]), dtype="int64")])
        assert out.dtype == np.int64


def test_host_read_ops_flush_the_bulk_segment_and_are_never_deferred():
    from mxnet_tpu_torch import engine

    with tmx.cpu(), engine.bulk(16):
        a = tmx.np.array(DUPS) * 1.0
        assert a._pending is not None
        u = treg.invoke("_npi_unique", [a])
        assert u._pending is None and a._pending is None
    np.testing.assert_array_equal(u.asnumpy(), np.unique(DUPS))


# -- samplers, by moments ------------------------------------------------------

N = 100_000


def _ok(x, mean, var, what):
    x = np.asarray(x, np.float64).ravel()
    m4 = ((x - x.mean()) ** 4).mean()
    assert abs(x.mean() - mean) < 5 * math.sqrt(var / x.size), \
        (what, x.mean(), mean)
    assert abs(x.var() - var) < 5 * math.sqrt((m4 - x.var() ** 2) / x.size) \
        + 1e-12, (what, x.var(), var)


def _draw(name, inputs, attrs):
    """The port's draw and the JAX op's output (shape and dtype only)."""
    import jax

    tmx.random.seed(7)
    got = treg.get(name).forward(*[torch.from_numpy(x) for x in inputs],
                                 **attrs)
    want = jreg.get(name).forward(jax.random.PRNGKey(0),
                                  *[jnp.asarray(x) for x in inputs],
                                  **attrs)
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    assert got.numpy().dtype == np.asarray(want).dtype, \
        (got.dtype, want.dtype)
    return got.numpy()


SAMPLERS = [
    ("_npi_uniform", [], {"low": -1.0, "high": 3.0, "size": (N,)},
     1.0, 16 / 12),
    ("_npi_uniform_n", [], {"size": (N,)}, 0.5, 1 / 12),
    ("_npi_normal", [], {"loc": 1.0, "scale": 2.0, "size": (N,)}, 1.0, 4.0),
    ("_npi_normal_n", [], {"size": (N,)}, 0.0, 1.0),
    ("_npi_bernoulli", [], {"prob": 0.3, "size": (N,)}, 0.3, 0.21),
    ("_npi_bernoulli", [], {"logit": 0.0, "is_logit": True, "size": (N,)},
     0.5, 0.25),
    ("_npi_exponential", [], {"scale": 2.0, "size": (N,)}, 2.0, 4.0),
    ("_npi_gamma", [], {"shape": 3.0, "scale": 2.0, "size": (N,)},
     6.0, 12.0),
    ("_npi_choice", [], {"a": 5, "size": (N,)}, 2.0, 2.0),
    ("_npi_choice", [np.array([0.1, 0.2, 0.7], np.float32)],
     {"a": 3, "size": (N,)}, 1.6, 0.44),
    ("_sample_poisson", [np.array([3.0], np.float32)], {"shape": (N,)},
     3.0, 3.0),
    ("_sample_exponential", [np.array([0.5], np.float32)], {"shape": (N,)},
     2.0, 4.0),
    ("_sample_negative_binomial", [np.array([3.0], np.float32),
                                   np.array([0.4], np.float32)],
     {"shape": (N,)}, 4.5, 11.25),
    ("_sample_generalized_negative_binomial",
     [np.array([2.0], np.float32), np.array([0.5], np.float32)],
     {"shape": (N,)}, 2.0, 4.0),
]


@pytest.mark.parametrize("name,inputs,attrs,mean,var", SAMPLERS,
                         ids=["%s-%d" % (s[0], i) for i, s in
                              enumerate(SAMPLERS)])
def test_sampler_matches_its_distribution(name, inputs, attrs, mean, var):
    _ok(_draw(name, inputs, attrs), mean, var, name)


def test_choice_without_replacement_and_multinomial():
    tmx.random.seed(1)
    idx = treg.get("_npi_choice").forward(a=10, size=(10,), replace=False)
    assert sorted(idx.tolist()) == list(range(10))
    p = np.array([0.2, 0.3, 0.5], np.float32)
    counts = _draw("_npi_multinomial", [p], {"n": 20, "size": (20000,)})
    assert (counts.sum(-1) == 20).all()
    _ok(counts[:, 2], 10.0, 5.0, "multinomial")


def test_samplers_are_rng_ops_and_never_deferred():
    for name in ("_npi_uniform", "_npi_normal", "_npi_bernoulli",
                 "_npi_exponential", "_npi_gamma", "_npi_choice",
                 "_npi_multinomial", "_sample_poisson",
                 "_sample_exponential", "_sample_negative_binomial",
                 "_sample_generalized_negative_binomial"):
        assert treg.get(name).needs_rng, name


# -- the table covers the module -------------------------------------------------


def test_every_op_of_npi_is_in_the_tables():
    names = {n for n, r in jreg._REGISTRY.items()
             if r.forward.__module__ == "mxnet_tpu.ops.npi"}
    with open(os.path.join(REPO, "mxnet_tpu", "ops", "npi.py")) as f:
        quoted = set(re.findall(r'"([A-Za-z0-9_]+)"', f.read()))
    names |= {a for a, n in jreg._ALIASES.items()
              if n in names and a in quoted}
    tested = {c[0] for c in CASES} | {c[0] for c in HOST_CASES} \
        | {s[0] for s in SAMPLERS} | {"_npi_svd", "_npi_multinomial"}
    assert len(names) == 162
    assert sorted(names - tested) == []
    assert sorted(tested - names) == []


def test_host_read_ops_refuse_a_capture():
    """Under a CUDA graph capture a host read raises ``MXNetError``
    naming the op (the card test drives a real capture; here the check
    is called as the capture would see it)."""
    from mxnet_tpu_torch import graph_cache

    calls = []
    orig = graph_cache.refuse_host_read

    def spy(what, tensor):
        calls.append(what)
        raise MXNetError("%s reads the device on the host" % what)

    graph_cache.refuse_host_read = spy
    try:
        for name, inputs, attrs in HOST_CASES[::3]:
            with tmx.cpu(), pytest.raises(MXNetError, match=name):
                treg.invoke(name, [tmx.np.array(x) for x in inputs],
                            dict(attrs))
    finally:
        graph_cache.refuse_host_read = orig
    assert len(calls) == len(HOST_CASES[::3])
