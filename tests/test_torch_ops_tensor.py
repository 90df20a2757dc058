"""The ops of the port's ``ops/tensor.py`` that came with the op tail
(``shape_array``, ``size_array``, ``make_loss``, ``amp_cast``,
``amp_multicast``, the gather and scatter family, ``boolean_mask_fill``,
``sort``, ``argsort``, ``topk``, ``diag``, ``einsum``, ``khatri_rao``,
the ``Sequence*`` ops and the ``_linalg_*`` family) against the JAX
package's, on the CPU, and the registry coverage test.

The same seeded numpy inputs go through both.  Indexing, ordering and
integer results must be bitwise equal, ties included; f32 arithmetic
within rtol 1e-5 / atol 1e-6; gradients are ``jax.vjp`` of the JAX op
with the same seeded head, within rtol 1e-4 / atol 1e-5 (the linalg
ones 1e-3 relative).  The factorizations whose signs are free (SVD,
``syevd``, ``gelqf``) are compared with their columns' signs aligned,
and their gradients with ``torch.autograd.gradcheck`` in float64.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ndarray  # noqa: F401  (registers the JAX package's ops)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(rtol=0, atol=0)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
LINALG = dict(rtol=1e-3, atol=1e-4)


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def check_op(name, inputs, attrs=None, diff=(), fwd=FWD, grad=GRAD):
    """Every output (value, shape, dtype) and the gradients of the
    inputs at ``diff`` (through the first output) against the JAX
    package's op."""
    attrs = attrs or {}
    jfwd = jreg.get(name).forward
    args = [jnp.asarray(x) for x in inputs]
    want = [np.asarray(o) for o in _outs(jfwd(*args, **attrs))]
    ts = [torch.from_numpy(np.array(x)) for x in inputs]
    for i in diff:
        ts[i].requires_grad_()
    got = _outs(treg.get(name).forward(*ts, **attrs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, **fwd)
    if not diff:
        return

    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        return _outs(jfwd(*full, **attrs))[0]

    out, vjp = jax.vjp(f, *[args[i] for i in diff])
    head = np.random.RandomState(11).standard_normal(out.shape).astype(
        np.asarray(out).dtype)
    want_g = vjp(jnp.asarray(head))
    got[0].backward(torch.from_numpy(head))
    for i, w in zip(diff, want_g):
        np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(w), **grad)


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


# -- the coverage test ---------------------------------------------------------------

# registered by the JAX package's ported op modules and not (yet) in the
# port, each with its reason
EXCLUDED = {}
THREE_MODULES = ("nn", "tensor", "random_ops")
JAX_MODULES = THREE_MODULES + ("vision", "contrib", "misc", "control_flow",
                               "pallas_kernels", "paged_attention",
                               "quantized_ops", "npi")


def _jax_names(modules=JAX_MODULES):
    """Every op name and alias the JAX modules ``modules`` register:
    primaries by the module of their forward, aliases by the module whose
    source names them."""
    names = {n for n, r in jreg._REGISTRY.items()
             if r.forward.__module__.rsplit(".", 1)[-1] in modules}
    src = ""
    for m in modules:
        with open(os.path.join(REPO, "mxnet_tpu", "ops", m + ".py")) as f:
            src += f.read()
    quoted = set(re.findall(r'"([A-Za-z0-9_]+)"', src))
    names |= {a for a, n in jreg._ALIASES.items()
              if n in names and a in quoted}
    return names


def _check_registered(modules, least):
    names = _jax_names(modules)
    assert len(names) > least, len(names)
    have = set(treg.list_ops())
    excluded = {n: why for n, why in EXCLUDED.items() if n in names}
    missing = sorted(n for n in names - have if n not in excluded)
    assert missing == [], missing
    # every exclusion is still needed and names its reason
    assert all(n not in have for n in excluded)
    assert all(excluded.values())


def test_every_op_of_the_three_modules_is_registered_in_the_port():
    _check_registered(THREE_MODULES, 300)


def test_every_op_of_the_ported_op_modules_is_registered_in_the_port():
    """The three modules, ``ops/vision.py``, ``ops/contrib.py``,
    ``ops/misc.py``, ``ops/control_flow.py``, the attention ops of
    ``ops/pallas_kernels.py`` and ``ops/paged_attention.py``, the 13
    of ``ops/quantized_ops.py`` and the 162 names of ``ops/npi.py``:
    every op is in the port but the listed exclusions."""
    _check_registered(JAX_MODULES, 400)
    assert set(EXCLUDED) <= _jax_names()


def test_ported_ops_keep_their_attrs_and_defaults():
    """Each ported op of the ported op modules takes the JAX op's
    attributes with the same defaults (the port may add ``device``)."""
    import inspect

    def attrs(fn, drop):
        return {p.name: p.default
                for p in inspect.signature(fn).parameters.values()
                if p.default is not inspect.Parameter.empty
                and p.name not in drop}

    for name in sorted(_jax_names() - set(EXCLUDED)):
        jr, tr = jreg.get(name), treg.get(name)
        want = attrs(jr.forward, ("key",) + tuple(jr.input_names))
        got = attrs(tr.forward, ("device", "generator")
                    + tuple(tr.input_names))
        for k, v in want.items():
            assert k in got, (name, k)
            if not isinstance(v, (tuple, list)) and v is not None:
                assert got[k] == v, (name, k, got[k], v)


# -- shape, size, casts ------------------------------------------------------------


@pytest.mark.parametrize("int64", [False, True])
def test_shape_and_size_array_match_jax(int64, monkeypatch):
    """int32, or int64 under ``MXNET_INT64_TENSOR_SIZE=1`` (the JAX
    package's x64 switch)."""
    x = torch.zeros(3, 4, 5)
    if int64:
        monkeypatch.setenv("MXNET_INT64_TENSOR_SIZE", "1")
    dt = torch.int64 if int64 else torch.int32
    got = treg.get("shape_array").forward(x)
    assert got.dtype == dt and got.tolist() == [3, 4, 5]
    got = treg.get("size_array").forward(x)
    assert got.dtype == dt and got.tolist() == [60]
    if not int64:
        check_op("shape_array", [np.zeros((3, 4, 5), np.float32)],
                 fwd=EXACT)


def test_make_loss_amp_cast_and_multicast_match_jax():
    check_op("make_loss", [_f32(3, 4)], diff=(0,), fwd=EXACT)
    check_op("amp_cast", [_f32(3, 4)], {"dtype": "float16"}, fwd=EXACT)
    a = np.ones((2,), np.float16)
    b = np.ones((2,), np.float32)
    c = np.ones((2,), np.int32)
    check_op("amp_multicast", [a, b, c], {"num_outputs": 3}, fwd=EXACT)
    got = treg.get("amp_multicast").forward(
        torch.ones(2, dtype=torch.bfloat16), torch.ones(2, dtype=torch.float16))
    assert all(t.dtype == torch.float32 for t in got)


# -- gather, scatter, masks --------------------------------------------------------


def test_gather_nd_matches_jax():
    data = _f32(4, 5, 3)
    idx = np.array([[0, 3, -1, 2], [4, 0, 1, -2]], np.float32)
    check_op("gather_nd", [data, idx], diff=(0,), fwd=EXACT)
    # out of range: clamped, as the JAX package's gather gives it
    idx = np.array([[0, 9, -7], [6, 1, 2]], np.int32)
    check_op("gather_nd", [data, idx], fwd=EXACT)


def test_scatter_nd_matches_jax():
    data = _f32(4, 3)
    idx = np.array([[0, 2, -1, 1], [1, 0, 2, 2]], np.int32)
    check_op("scatter_nd", [data, idx], {"shape": (3, 3, 3)}, diff=(0,),
             fwd=EXACT)


def test_scatter_nd_drops_indices_out_of_range_as_jax():
    data = _f32(3)
    idx = np.array([[0, 5, 2]], np.int32)
    check_op("scatter_nd", [data, idx], {"shape": (4,)}, fwd=EXACT)


def test_scatter_set_nd_matches_jax():
    lhs = _f32(3, 4)
    rhs = _f32(2, seed=1)
    idx = np.array([[0, 2], [3, 1]], np.int32)
    check_op("_scatter_set_nd", [lhs, rhs, idx], {"shape": (3, 4)},
             diff=(0, 1), fwd=EXACT)


def test_boolean_mask_fill_matches_jax():
    data = _f32(4, 3)
    mask = np.array([1, 0, 0, 1], np.float32)
    check_op("boolean_mask_fill", [data, mask], {"value": -2.5}, diff=(0,),
             fwd=EXACT)


# -- ordering, ties included --------------------------------------------------------


TIES = np.array([[3, 1, 3, 2, 1, 3],
                 [0, 0, 5, 5, 0, 2],
                 [7, 7, 7, 7, 7, 7]], np.float32)


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("is_ascend", [True, False])
def test_sort_and_argsort_with_ties_match_jax_bitwise(axis, is_ascend):
    attrs = {"axis": axis, "is_ascend": is_ascend}
    check_op("sort", [TIES], attrs, diff=(0,), fwd=EXACT)
    check_op("argsort", [TIES], attrs, fwd=EXACT)
    check_op("argsort", [TIES], dict(attrs, dtype="int32"), fwd=EXACT)


@pytest.mark.parametrize("ret_typ", ["indices", "value", "both"])
@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_topk_with_ties_matches_jax_bitwise(ret_typ, is_ascend, axis):
    attrs = {"axis": axis, "k": 2, "ret_typ": ret_typ,
             "is_ascend": is_ascend}
    check_op("topk", [TIES], attrs,
             diff=(0,) if ret_typ != "indices" else (), fwd=EXACT)


def test_ndarray_ordering_methods_match_jax():
    """``one_hot``, ``sort``, ``argsort`` and ``topk`` as NDArray methods
    (they raised before the op tail came)."""
    x = TIES
    jx, tx = jmx.nd.array(x), tmx.nd.array(x, ctx=tmx.cpu())
    for m, kw in (("sort", {}), ("argsort", {"is_ascend": False}),
                  ("topk", {"k": 3}), ("topk", {"k": 2, "ret_typ": "value",
                                                "axis": 0})):
        np.testing.assert_array_equal(getattr(tx, m)(**kw).asnumpy(),
                                      getattr(jx, m)(**kw).asnumpy())
    ids = np.array([0, 2, 1], np.float32)
    np.testing.assert_array_equal(
        tmx.nd.array(ids, ctx=tmx.cpu()).one_hot(3, on_value=2.0).asnumpy(),
        jmx.nd.array(ids).one_hot(3, on_value=2.0).asnumpy())


# -- diag, einsum, khatri_rao ------------------------------------------------------


@pytest.mark.parametrize("shape,k", [((4,), 1), ((4, 5), -1), ((3, 4, 2), 1)])
def test_diag_matches_jax(shape, k):
    check_op("diag", [_f32(*shape)], {"k": k}, diff=(0,), fwd=EXACT)


def test_einsum_and_khatri_rao_match_jax():
    a, b = _f32(3, 4), _f32(4, 5, seed=1)
    check_op("_npi_einsum", [a, b], {"subscripts": "ij,jk->ik"},
             diff=(0, 1))
    check_op("einsum", [a], {"subscripts": "ij->j"}, diff=(0,))
    c = _f32(2, 4, seed=2)
    check_op("khatri_rao", [a, c, _f32(3, 4, seed=3)], diff=(0, 1, 2))


# -- sequence ops --------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_ops_match_jax(axis):
    data = _f32(5, 3, 2) if axis == 0 else _f32(3, 5, 2)
    lengths = np.array([2, 5, 1], np.float32)
    kw = {"use_sequence_length": True, "axis": axis}
    check_op("SequenceMask", [data, lengths], dict(kw, value=-1.0),
             diff=(0,), fwd=EXACT)
    check_op("SequenceLast", [data, lengths], kw, diff=(0,), fwd=EXACT)
    check_op("SequenceLast", [data], {"axis": axis}, diff=(0,), fwd=EXACT)
    check_op("SequenceMask", [data], {"axis": axis}, fwd=EXACT)


def test_sequence_reverse_matches_jax():
    data = _f32(5, 3, 2)
    lengths = np.array([2, 5, 1], np.float32)
    check_op("SequenceReverse", [data, lengths],
             {"use_sequence_length": True}, diff=(0,), fwd=EXACT)
    check_op("SequenceReverse", [data], {}, diff=(0,), fwd=EXACT)


# -- linalg --------------------------------------------------------------------------


def _spd(n, seed=0, batch=()):
    a = _f32(*(batch + (n, n)), seed=seed)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)) \
        .astype(np.float32)


def _lower(n, seed=0):
    return (np.tril(_f32(n, n, seed=seed)) + 3 * np.eye(n)).astype(
        np.float32)


LINALG_CASES = [
    ("_linalg_gemm2", lambda: [_f32(2, 3, 4), _f32(2, 5, 4, seed=1)],
     {"transpose_b": True, "alpha": 0.5}, (0, 1)),
    ("_linalg_gemm", lambda: [_f32(3, 4), _f32(4, 2, seed=1),
                              _f32(3, 2, seed=2)],
     {"alpha": 2.0, "beta": 0.5}, (0, 1, 2)),
    ("_linalg_syrk", lambda: [_f32(3, 4)], {"transpose": True,
                                            "alpha": 1.5}, (0,)),
    ("_linalg_potrf", lambda: [_spd(4)], {}, (0,)),
    ("_linalg_trsm", lambda: [_lower(4), _f32(4, 3, seed=1)],
     {"alpha": 2.0}, (0, 1)),
    ("_linalg_trsm", lambda: [_lower(4), _f32(3, 4, seed=1)],
     {"rightside": True, "transpose": True}, (0, 1)),
    ("_linalg_sumlogdiag", lambda: [_spd(4, batch=(2,))], {}, (0,)),
    ("_linalg_extractdiag", lambda: [_f32(2, 4, 4)], {"offset": 1}, (0,)),
    ("_linalg_makediag", lambda: [_f32(2, 4)], {}, (0,)),
    ("_linalg_makediag", lambda: [_f32(2, 4)], {"offset": 1}, ()),
    ("_linalg_inverse", lambda: [_spd(4)], {}, (0,)),
    ("_linalg_det", lambda: [_spd(3, batch=(2,))], {}, (0,)),
    ("_linalg_slogdet", lambda: [_spd(3, batch=(2,))], {}, ()),
    ("_linalg_extracttrian", lambda: [_f32(2, 4, 4)], {"offset": 1},
     (0,)),
    ("_linalg_extracttrian", lambda: [_f32(4, 4)],
     {"lower": False, "offset": 1}, (0,)),
    ("_linalg_maketrian", lambda: [_f32(2, 6)], {"offset": 1}, (0,)),
    ("_linalg_maketrian", lambda: [_f32(10)], {"lower": False}, (0,)),
    ("_linalg_potri", lambda: [_lower(4)], {}, (0,)),
    ("_linalg_potri", lambda: [_lower(4).T.copy()], {"lower": False}, (0,)),
    ("_linalg_trmm", lambda: [_f32(4, 4), _f32(4, 3, seed=1)],
     {"alpha": 1.5}, (0, 1)),
    ("_linalg_trmm", lambda: [_f32(4, 4), _f32(3, 4, seed=1)],
     {"rightside": True, "transpose": True, "lower": False}, (0, 1)),
]


@pytest.mark.parametrize("name,make,attrs,diff", LINALG_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(LINALG_CASES)])
def test_linalg_ops_match_jax(name, make, attrs, diff):
    check_op(name, make(), attrs, diff=diff, fwd=LINALG, grad=LINALG)
    alias = name[1:]
    if alias in treg.list_ops():
        assert treg.get(alias) is treg.get(name)


def _signs_aligned(got, want, axis):
    """``got`` with each vector along ``axis`` flipped to ``want``'s
    sign."""
    s = np.sign(np.sum(got * want, axis=axis, keepdims=True))
    return got * np.where(s == 0, 1, s)


def test_svd_syevd_gelqf_match_jax_up_to_signs():
    a = _f32(2, 4, 3)
    ju, js, jvt = (np.asarray(o) for o in jreg.get("_linalg_svd").forward(
        jnp.asarray(a)))
    tu, ts_, tvt = (o.numpy() for o in treg.get("_linalg_svd").forward(
        torch.from_numpy(a)))
    np.testing.assert_allclose(ts_, js, **LINALG)
    np.testing.assert_allclose(_signs_aligned(tu, ju, -2), ju, **LINALG)
    np.testing.assert_allclose(_signs_aligned(tvt, jvt, -1), jvt, **LINALG)
    s = _spd(4)
    ju, jl = (np.asarray(o) for o in jreg.get("_linalg_syevd").forward(
        jnp.asarray(s)))
    tu, tl = (o.numpy() for o in treg.get("_linalg_syevd").forward(
        torch.from_numpy(s)))
    np.testing.assert_allclose(tl, jl, **LINALG)
    np.testing.assert_allclose(_signs_aligned(tu, ju, -1), ju, **LINALG)
    np.testing.assert_allclose(tu.T @ np.diag(tl) @ tu, s, **LINALG)
    g = _f32(3, 5)
    jl_, jq = (np.asarray(o) for o in jreg.get("_linalg_gelqf").forward(
        jnp.asarray(g)))
    tl_, tq = (o.numpy() for o in treg.get("_linalg_gelqf").forward(
        torch.from_numpy(g)))
    np.testing.assert_allclose(_signs_aligned(tq, jq, -1), jq, **LINALG)
    np.testing.assert_allclose(tl_ @ tq, g, **LINALG)
    np.testing.assert_allclose(tq @ tq.T, np.eye(3), **LINALG)


def test_factorization_gradients_pass_gradcheck_in_f64():
    """Gradients through the sign-free parts of the factorizations (the
    JAX op's vjp depends on its signs): float64 ``gradcheck``."""
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.standard_normal((4, 3))).requires_grad_()
    svd = treg.get("_linalg_svd").forward

    def recon(x):
        u, s, vt = svd(x)
        return u @ torch.diag_embed(s) @ vt, s
    assert torch.autograd.gradcheck(recon, (a,))
    s = torch.from_numpy(_spd(4).astype(np.float64)).requires_grad_()
    syevd = treg.get("_linalg_syevd").forward
    # eigh reads one triangle: perturb the matrix symmetrically
    assert torch.autograd.gradcheck(
        lambda x: syevd((x + x.T) / 2)[1], (s,))
    g = torch.from_numpy(rng.standard_normal((3, 5))).requires_grad_()
    gelqf = treg.get("_linalg_gelqf").forward
    assert torch.autograd.gradcheck(
        lambda x: (lambda lq: lq[0] @ lq[1])(gelqf(x)), (g,))
