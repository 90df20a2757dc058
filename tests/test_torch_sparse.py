"""The port's sparse storage against the JAX package's, on the CPU.

The cases of ``tests/test_sparse.py`` (its two kvstore cases aside: the
kvstore is slice S8) run through both packages on the same numpy-seeded
inputs: the sparse ``Embedding`` gradient, the lazy SGD and Adam
updates, Gluon end to end, the csr dot in both modes, rsp add and
compact, the parametrised sweeps of cast_storage, add, multiply,
square_sum, retain and dot, ``cast_storage`` in a recorded graph and
multiply commuting.  Then what the slice adds around them: R15 (ids out
of range) as the port behaves with the JAX package's result stated
beside it, a hybridized block's gradient stype, ``write`` against
``add``, the dense update ops, the DGL CSR ops, and the slice as a whole
at small size (the matrix-factorization recommender, the
``SparseEmbedding`` net and the sparse linear classification on the
committed libsvm file), with weights carried from the JAX nets through
``.params`` files.

Tolerances (f32): values that are copied or gathered are compared
exactly (indices by value: int32 there, int64 here); sums and updates
within rtol 1e-5 / atol 1e-6, and trained weights and losses within
rtol 1e-4 / atol 1e-5 (the two frameworks sum in different orders and
the differences grow over steps).  On the CPU the kernels O7 and O8 run
their plain versions.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsparse
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse as tsparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
TRAINED = dict(rtol=1e-4, atol=1e-5)
PKGS = ((jmx, jsparse), (tmx, tsparse))


@pytest.fixture(autouse=True)
def host():
    with tmx.cpu():
        yield


def _both(fn):
    """``fn(mx, sparse)`` for the JAX package, then for the port."""
    return [fn(mx, sp) for mx, sp in PKGS]


def _same(got, want, exact=False, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


# -- tests/test_sparse.py's cases ------------------------------------------


def test_embedding_sparse_grad_matches_dense():
    rs = np.random.RandomState(0)
    w_np = rs.randn(10, 4).astype(np.float32)
    ids_np = np.array([1, 3, 3, 7], np.int32)
    ct = rs.randn(4, 4).astype(np.float32)

    def run(mx, sp):
        out = []
        for sparse_grad in (False, True):
            w = mx.nd.array(w_np)
            w.attach_grad()
            with mx.autograd.record():
                y = mx.nd.Embedding(mx.nd.array(ids_np), w, input_dim=10,
                                    output_dim=4, sparse_grad=sparse_grad)
            y.backward(mx.nd.array(ct))
            out.append(w.grad)
        dense, rsp = out
        assert isinstance(rsp, sp.RowSparseNDArray)
        assert sorted(rsp.indices.asnumpy().tolist()) == [1, 3, 7]
        _same(rsp.asnumpy(), dense.asnumpy())
        return rsp.indices.asnumpy(), rsp.asnumpy()

    (ji, jg), (ti, tg) = _both(run)
    _same(ti, ji, exact=True)
    _same(tg, jg)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9)), ("sgd", dict()),
    ("adam", dict()), ("adagrad", dict()), ("nag", dict(momentum=0.9)),
    ("rmsprop", dict()), ("adamw", dict())])
def test_sparse_lazy_update_matches_jax(name, kw):
    """``Optimizer.update`` with a row-sparse gradient (duplicate rows,
    unsorted): untouched rows and their state stay, touched rows follow
    the dense formula, and the port's weight and state equal the JAX
    package's, for O8's routes (SGD, Adam, AdaGrad) and the generic one
    (NAG, RMSProp, AdamW)."""
    rs = np.random.RandomState(1)
    w0 = rs.randn(8, 3).astype(np.float32)
    vals = rs.randn(3, 3).astype(np.float32)
    idx = np.array([5, 2, 5], np.int64)
    hyper = dict(learning_rate=0.5, wd=0.01, rescale_grad=0.5,
                 clip_gradient=1.0, **kw)

    def run(mx, sp):
        opt = mx.optimizer.create(name, **hyper)
        state = opt.create_state(0, mx.nd.array(w0))
        w = mx.nd.array(w0)
        rsp = sp.RowSparseNDArray(vals, idx, (8, 3))
        new_state = opt.update(0, w, rsp, state)
        if mx is jmx:
            state = new_state[1]
        out = w.asnumpy()
        untouched = [i for i in range(8) if i not in (2, 5)]
        _same(out[untouched], w0[untouched], exact=True)
        leaves = [np.asarray(s) for s in (
            state if isinstance(state, (tuple, list)) else [state])
            if s is not None]
        for leaf in leaves:
            assert (leaf[untouched] == 0).all()
        return out, leaves

    (jw, js), (tw, ts) = _both(run)
    _same(tw, jw)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        _same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,kw,route", [
    ("sgd", dict(), "sgd"), ("sgd", dict(momentum=0.9), "sgd_mom"),
    ("adam", dict(), "adam"), ("adagrad", dict(), "adagrad"),
    ("nag", dict(momentum=0.9), None), ("adamw", dict(), None)])
def test_lazy_route_follows_the_optimizer_type_alone(monkeypatch, name, kw,
                                                     route, dtype):
    """The lazy update's route is chosen by the optimizer's type, never
    by the dtypes: SGD, Adam and AdaGrad reach O8's wrapper with a bf16
    table too (on the card O8 raises there: it takes f32), the others
    take the generic route.  O8's plain version, which the CPU runs, is
    plain torch: it never calls the O1/O2 wrappers.  The listed rows
    move, the others keep their bytes."""
    from mxnet_tpu_torch.ops import optimizer_ops as oo
    from mxnet_tpu_torch.ops import sparse_ops as sops

    calls = []
    real = sops.rsp_lazy_update

    def spy(*args, **kwargs):
        calls.append(args[4])
        return real(*args, **kwargs)

    monkeypatch.setattr(sops, "rsp_lazy_update", spy)
    if route is not None:
        def kernel_wrapper(*args, **kwargs):
            raise AssertionError("O8's plain version called a kernel wrapper")

        monkeypatch.setattr(oo, "multi_sgd", kernel_wrapper)
        monkeypatch.setattr(oo, "multi_adamw", kernel_wrapper)
    rs = np.random.RandomState(2)
    w0 = torch.from_numpy(rs.randn(8, 3).astype(np.float32)).to(dtype)
    opt = tmx.optimizer.create(name, learning_rate=0.5, **kw)
    w = w0.clone()
    state = opt.create_state(0, w)
    rsp = tsparse.RowSparseNDArray(rs.randn(2, 3).astype(np.float32),
                                   np.array([6, 1], np.int64), (8, 3))
    opt.update(0, w, rsp, state)
    assert calls == ([] if route is None else [route])
    untouched = [i for i in range(8) if i not in (1, 6)]
    assert torch.equal(w[untouched], w0[untouched])
    assert not torch.equal(w[[1, 6]], w0[[1, 6]])


def test_sparse_sgd_lazy_update():
    """The touched rows follow the dense SGD formula (the reference
    case, through the port)."""
    rs = np.random.RandomState(1)
    w0 = rs.randn(8, 3).astype(np.float32)
    opt = tmx.optimizer.create("sgd", learning_rate=0.5, momentum=0.9)
    state = opt.create_state(0, tmx.nd.array(w0))
    rsp = tsparse.RowSparseNDArray(
        np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32),
        np.array([2, 5], np.int64), (8, 3))
    w = tmx.nd.array(w0)
    opt.update(0, w, rsp, state)
    opt2 = tmx.optimizer.create("sgd", learning_rate=0.5, momentum=0.9)
    st2 = opt2.create_state(0, tmx.nd.array(w0))
    w2 = tmx.nd.array(w0)
    opt2.update(0, w2, tmx.nd.array(rsp.asnumpy()), st2)
    _same(w.asnumpy()[[2, 5]], w2.asnumpy()[[2, 5]])


def test_sparse_adam_momentum_rows_only():
    """Adam's state rows for untouched ids stay zero (lazy_update)."""
    w0 = np.ones((6, 2), np.float32)
    opt = tmx.optimizer.create("adam", learning_rate=0.1)
    state = opt.create_state(0, tmx.nd.array(w0))
    rsp = tsparse.RowSparseNDArray(np.ones((1, 2), np.float32),
                                   np.array([4], np.int64), (6, 2))
    opt.update(0, tmx.nd.array(w0), rsp, state)
    for leaf in state:
        leaf = leaf.numpy()
        assert (leaf[[0, 1, 2, 3, 5]] == 0).all()
        assert not (leaf[4] == 0).all()


def _embed_net(mx, sparse_grad, vocab=20, dim=6):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Embedding(vocab, dim, sparse_grad=sparse_grad))
    net.add(mx.gluon.nn.Dense(1))
    return net


def test_gluon_embedding_sparse_e2e(tmp_path):
    """A linear + embedding model trains with sparse gradients as with
    dense ones, in each package, and the port's weights and loss equal
    the JAX package's (weights carried through a ``.params`` file)."""
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 20, (16,)).astype(np.int32)
    y = rs.randn(16, 1).astype(np.float32)
    jmx.random.seed(3)
    init = _embed_net(jmx, False)
    init.initialize(jmx.init.Xavier())
    init(jmx.nd.array(ids))
    f = str(tmp_path / "net.params")
    init.save_parameters(f)

    def train(mx, sparse_grad):
        net = _embed_net(mx, sparse_grad)
        net.initialize()
        net(mx.nd.array(ids))
        net.load_parameters(f)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        loss_fn = mx.gluon.loss.L2Loss()
        for _ in range(5):
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(ids)), mx.nd.array(y))
            loss.backward()
            if sparse_grad:
                assert net[0].weight.grad().stype == "row_sparse"
            trainer.step(16)
        return net[0].weight.data().asnumpy(), float(loss.mean().asnumpy())

    got = {(mx is tmx, sg): train(mx, sg) for mx, _ in PKGS
           for sg in (False, True)}
    for port in (False, True):
        _same(got[port, True][0], got[port, False][0])
        assert abs(got[port, True][1] - got[port, False][1]) < 1e-5
    _same(got[True, True][0], got[False, True][0])
    assert abs(got[True, True][1] - got[False, True][1]) < 1e-5


def test_csr_dot_sparse_kernel():
    """O7's both modes (its plain version here) against the dense product
    and the JAX package."""
    rs = np.random.RandomState(4)
    dense = rs.randn(5, 7).astype(np.float32)
    dense[dense < 0.3] = 0
    rhs = rs.randn(7, 3).astype(np.float32)
    rhs_t = rs.randn(5, 3).astype(np.float32)

    def run(mx, sp):
        csr = sp.csr_matrix(dense)
        out = sp.dot(csr, mx.nd.array(rhs)).asnumpy()
        np.testing.assert_allclose(out, dense @ rhs, rtol=1e-4, atol=1e-5)
        out_t = sp.dot(csr, mx.nd.array(rhs_t), transpose_a=True).asnumpy()
        assert out_t.shape == (7, 3)
        np.testing.assert_allclose(out_t, dense.T @ rhs_t, rtol=1e-4,
                                   atol=1e-5)
        return out, out_t

    (jo, jt), (to, tt) = _both(run)
    _same(to, jo)
    _same(tt, jt)


def test_rowsparse_add_and_compact():
    def run(mx, sp):
        a = sp.RowSparseNDArray(np.ones((2, 2), np.float32),
                                np.array([1, 3], np.int64), (5, 2))
        b = sp.RowSparseNDArray(np.full((2, 2), 5.0, np.float32),
                                np.array([3, 0], np.int64), (5, 2))
        c = a + b
        assert isinstance(c, sp.RowSparseNDArray)
        expect = np.zeros((5, 2), np.float32)
        expect[1], expect[3], expect[0] = 1, 6, 5
        _same(c.asnumpy(), expect, exact=True)
        assert c.indices.asnumpy().tolist() == [0, 1, 3]
        return c.asnumpy()

    jc, tc = _both(run)
    _same(tc, jc, exact=True)


def _rand_dense(shape, density, seed):
    rs = np.random.RandomState(seed)
    arr = rs.randn(*shape).astype(np.float32)
    return arr * (rs.rand(*shape) < density)


def _rand_rsp(sp, shape, density, seed):
    rs = np.random.RandomState(seed)
    arr = rs.randn(*shape).astype(np.float32)
    return sp.row_sparse_array(arr * (rs.rand(shape[0]) < density)[:, None])


_GRID = [((5, 7), 0.3, 0), ((1, 4), 0.9, 1), ((16, 3), 0.05, 2),
         ((8, 8), 0.0, 3)]


@pytest.mark.parametrize("shape,density,seed", _GRID)
def test_sweep_cast_storage_round_trips(shape, density, seed):
    dense = _rand_dense(shape, density, seed)

    def run(mx, sp):
        out = []
        for stype, cls in (("csr", sp.CSRNDArray),
                           ("row_sparse", sp.RowSparseNDArray)):
            spa = mx.nd.cast_storage(mx.nd.array(dense), stype)
            assert isinstance(spa, cls) and spa.stype == stype
            back = mx.nd.cast_storage(spa, "default")
            _same(back.asnumpy(), dense, exact=True)
            other = "row_sparse" if stype == "csr" else "csr"
            cross = sp.cast_storage(spa, other)
            assert cross.stype == other
            _same(cross.tostype("default").asnumpy(), dense, exact=True)
            out.append(spa.indices.asnumpy())
        return out

    for a, b in zip(*_both(run)):
        _same(b, a, exact=True)


@pytest.mark.parametrize("shape,density,seed", _GRID)
def test_sweep_csr_add(shape, density, seed):
    a_np = _rand_dense(shape, density, seed)
    b_np = _rand_dense(shape, density, seed + 10)

    def run(mx, sp):
        out = sp.add(sp.csr_matrix(a_np), sp.csr_matrix(b_np))
        assert out.stype == "csr"
        _same(out.tostype("default").asnumpy(), a_np + b_np)
        return out.indptr.asnumpy(), out.indices.asnumpy(), \
            out.data_arr.asnumpy()

    for a, b in zip(*_both(run)):
        _same(b, a, exact=True)


@pytest.mark.parametrize("shape,density,seed", _GRID)
def test_sweep_rsp_add(shape, density, seed):
    def run(mx, sp):
        a = _rand_rsp(sp, shape, density, seed)
        b = _rand_rsp(sp, shape, density, seed + 10)
        out = sp.add(a, b)
        assert out.stype == "row_sparse"
        _same(out.tostype("default").asnumpy(),
              a.tostype("default").asnumpy() + b.tostype("default").asnumpy())
        return out.indices.asnumpy(), out.asnumpy()

    for a, b in zip(*_both(run)):
        _same(b, a, exact=True)


@pytest.mark.parametrize("shape,density,seed", _GRID)
def test_sweep_multiply_pattern_intersection(shape, density, seed):
    a_np = _rand_dense(shape, density, seed)
    b_np = _rand_dense(shape, density, seed + 10)

    def run(mx, sp):
        out = sp.multiply(sp.csr_matrix(a_np), sp.csr_matrix(b_np))
        assert out.stype == "csr"
        _same(out.tostype("default").asnumpy(), a_np * b_np)
        ra = _rand_rsp(sp, shape, density, seed)
        rb = _rand_rsp(sp, shape, density, seed + 5)
        rout = sp.multiply(ra, rb)
        assert rout.stype == "row_sparse"
        _same(rout.tostype("default").asnumpy(),
              ra.tostype("default").asnumpy()
              * rb.tostype("default").asnumpy())
        return out.tostype("default").asnumpy(), rout.indices.asnumpy(), \
            rout.asnumpy()

    for a, b in zip(*_both(run)):
        _same(b, a, exact=True)


@pytest.mark.parametrize("shape,density,seed", _GRID)
def test_sweep_multiply_scalar_and_dense(shape, density, seed):
    a_np = _rand_dense(shape, density, seed)
    d_np = _rand_dense(shape, 1.0, seed + 3) + 1.0

    def run(mx, sp):
        a = sp.csr_matrix(a_np)
        out = sp.multiply(a, 2.5)
        assert out.stype == "csr"
        _same(out.tostype("default").asnumpy(), a_np * 2.5)
        d = mx.nd.array(d_np)
        out2 = sp.multiply(a, d)
        assert out2.stype == "csr"
        _same(out2.tostype("default").asnumpy(), a_np * d_np)
        r = _rand_rsp(sp, shape, density, seed)
        out3 = sp.multiply(r, d)
        assert out3.stype == "row_sparse"
        _same(out3.tostype("default").asnumpy(),
              r.tostype("default").asnumpy() * d_np)
        return [o.tostype("default").asnumpy() for o in (out, out2, out3)]

    for a, b in zip(*_both(run)):
        _same(b, a, exact=True)


@pytest.mark.parametrize("shape,density,seed", _GRID)
def test_sweep_square_sum_vs_dense_oracle(shape, density, seed):
    def run(mx, sp):
        r = _rand_rsp(sp, shape, density, seed)
        dense = r.tostype("default").asnumpy()
        full = sp.square_sum(r).asnumpy()
        _same(full, np.sum(dense ** 2), tol=dict(rtol=1e-5, atol=1e-6))
        out = sp.square_sum(r, axis=1)
        assert out.stype == "row_sparse"
        _same(out.tostype("default").asnumpy(), np.sum(dense ** 2, axis=1))
        out_k = sp.square_sum(r, axis=1, keepdims=True)
        _same(out_k.tostype("default").asnumpy(),
              np.sum(dense ** 2, axis=1, keepdims=True))
        ax0 = sp.square_sum(r, axis=0).asnumpy()
        _same(ax0, np.sum(dense ** 2, axis=0))
        c = sp.csr_matrix(_rand_dense(shape, density, seed))
        cs = sp.square_sum(c).asnumpy()
        _same(cs, np.sum(c.tostype("default").asnumpy() ** 2))
        return full, out.tostype("default").asnumpy(), ax0, cs

    for a, b in zip(*_both(run)):
        _same(b, a)


@pytest.mark.parametrize("shape,density,seed", _GRID)
def test_sweep_retain_and_dot(shape, density, seed):
    rhs = np.random.RandomState(seed + 7).randn(shape[1], 3) \
        .astype(np.float32)
    rhs_t = np.random.RandomState(seed + 8).randn(shape[0], 3) \
        .astype(np.float32)

    def run(mx, sp):
        r = _rand_rsp(sp, shape, density, seed)
        keep = np.arange(0, shape[0], 2, dtype=np.int64)
        out = sp.retain(r, keep)
        dense = r.tostype("default").asnumpy().copy()
        mask = np.zeros(shape[0], bool)
        mask[keep] = True
        dense[~mask] = 0
        _same(out.tostype("default").asnumpy(), dense, exact=True)
        c = sp.csr_matrix(_rand_dense(shape, density, seed))
        got = sp.dot(c, mx.nd.array(rhs)).asnumpy()
        np.testing.assert_allclose(got, c.tostype("default").asnumpy() @ rhs,
                                   rtol=1e-4, atol=1e-5)
        got_t = sp.dot(c, mx.nd.array(rhs_t), transpose_a=True).asnumpy()
        assert got_t.shape == (shape[1], 3)
        return out.indices.asnumpy(), got, got_t

    (ji, jd, jt), (ti, td, tt) = _both(run)
    _same(ti, ji, exact=True)
    _same(td, jd)
    _same(tt, jt)


def test_cast_storage_in_graph_stays_differentiable():
    """In-graph ``cast_storage`` stays on the dense registered op, so
    autograd runs through it; an eager call gives a real sparse array."""
    def run(mx, sp):
        x = mx.nd.array(np.ones((2, 2), np.float32))
        x.attach_grad()
        with mx.autograd.record():
            z = mx.nd.cast_storage(x, "row_sparse") * 3.0
        z.backward()
        _same(x.grad.asnumpy(), np.full((2, 2), 3.0, np.float32), exact=True)
        assert mx.nd.cast_storage(mx.nd.array(np.eye(3)), "csr").stype \
            == "csr"

    _both(run)


def test_multiply_commutes_dense_sparse():
    def run(mx, sp):
        c = sp.csr_matrix(_rand_dense((5, 7), 0.3, 0))
        d = mx.nd.array(_rand_dense((5, 7), 1.0, 1) + 1.0)
        out = sp.multiply(d, c)
        assert out.stype == "csr"
        _same(out.tostype("default").asnumpy(),
              c.tostype("default").asnumpy() * d.asnumpy())
        return out.tostype("default").asnumpy()

    a, b = _both(run)
    _same(b, a, exact=True)


# -- what the slice adds around them ---------------------------------------


def test_r15_out_of_range_ids_move_the_rows_the_forward_read():
    """R15 (ROADMAP.md §3), not copied: with ids [1, 1, 5, -1] into a
    (4, 2) table, the sparse forward reads rows 1, 1, 3, 0 (clipped) in
    both packages.  The port's gradient lists those rows, [0, 1, 3] with
    [[1, 1], [2, 2], [1, 1]], and one SGD step at lr 1 moves rows 0, 1
    and 3 by -1, -2 and -1.  The JAX package lists the raw ids [-1, 1, 5]
    and its update drops id 5 and wraps -1, so it moves rows 1 and 3
    only (row 0, which id -1 read, stays)."""
    table = np.arange(8, dtype=np.float32).reshape(4, 2)
    ids = np.array([1, 1, 5, -1], np.float32)

    def run(mx, sp):
        emb = mx.gluon.nn.Embedding(4, 2, sparse_grad=True)
        emb.initialize()
        emb.weight.set_data(mx.nd.array(table))
        with mx.autograd.record():
            out = emb(mx.nd.array(ids))
        out.backward()
        g = emb.weight.grad()
        idx, vals = g.indices.asnumpy().tolist(), g.values.asnumpy()
        mx.gluon.Trainer(emb.collect_params(), "sgd",
                         {"learning_rate": 1.0}).step(1)
        return out.asnumpy(), idx, vals, emb.weight.data().asnumpy() - table

    (jo, ji, jv, jd), (to, ti, tv, td) = _both(run)
    _same(to, jo, exact=True)
    _same(to, table[[1, 1, 3, 0]], exact=True)
    assert ti == [0, 1, 3]
    _same(tv, [[1, 1], [2, 2], [1, 1]], exact=True)
    _same(td, [[-1, -1], [-2, -2], [0, 0], [-1, -1]], exact=True)
    # the JAX package's, stated: the raw ids, and row 0 unmoved
    assert ji == [-1, 1, 5]
    _same(jv, [[1, 1], [2, 2], [1, 1]], exact=True)
    _same(jd, [[0, 0], [-2, -2], [0, 0], [-1, -1]], exact=True)


def test_hybridized_block_gives_a_row_sparse_gradient():
    """A hybridized block holding ``Embedding(sparse_grad=True)``: its
    first recorded call gives a row-sparse gradient in both packages,
    with the same rows.  The port gives one at every call (it runs these
    calls eagerly and counts them, ``stats()["sparse_calls"]``); the JAX
    package's later calls run its compiled executable and give a dense
    gradient, stated here."""
    ids = np.array([[1, 4], [4, 9]], np.float32)
    table = np.random.RandomState(6).randn(10, 3).astype(np.float32)

    def run(mx, sp):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Embedding(10, 3, sparse_grad=True))
        net.initialize()
        net[0].weight.set_data(mx.nd.array(table))
        net.hybridize()
        got = []
        for _ in range(2):
            with mx.autograd.record():
                out = net(mx.nd.array(ids))
            out.backward()
            g = net[0].weight.grad()
            got.append((g.stype, g.asnumpy()))
        return got, net

    (jgot, _), (tgot, net) = _both(run)
    assert jgot[0][0] == tgot[0][0] == "row_sparse"
    _same(tgot[0][1], jgot[0][1], exact=True)
    assert tgot[1][0] == "row_sparse" and jgot[1][0] == "default"
    _same(tgot[1][1], jgot[1][1], exact=True)
    assert net.stats()["sparse_calls"] == 2


@pytest.mark.parametrize("req", ["write", "add"])
def test_write_against_add_on_sparse_and_dense_gradients(req):
    """``grad_req`` with row-sparse cotangents, in both packages: two
    backward passes through the sparse Embedding give the last one's
    rows, row-sparse (write), or both scattered into ``attach_grad``'s
    dense buffer (add); then a dense backward replaces the row-sparse
    gradient (write) or adds to the dense one (add)."""
    table = np.random.RandomState(7).randn(6, 2).astype(np.float32)

    def run(mx, sp):
        w = mx.nd.array(table)
        w.attach_grad(grad_req=req)
        got = []
        for ids in ([1, 3], [3, 4]):
            with mx.autograd.record():
                y = mx.nd.Embedding(mx.nd.array(np.array(ids, np.float32)),
                                    w, input_dim=6, output_dim=2,
                                    sparse_grad=True)
            y.backward()
            g = w.grad
            got.append((g.stype, getattr(g, "indices", None), g.asnumpy()))
        with mx.autograd.record():
            z = (w * 2.0).sum()
        z.backward()
        got.append((w.grad.stype, None, w.grad.asnumpy()))
        return got

    want, have = _both(run)
    for (js, ji, jg), (ts, ti, tg) in zip(want, have):
        assert ts == js
        if ji is not None:
            _same(ti.asnumpy(), ji.asnumpy(), exact=True)
        _same(tg, jg, exact=True)
    assert [h[0] for h in have] == (["row_sparse"] * 2 + ["default"]
                                    if req == "write" else ["default"] * 3)


def test_parameter_grad_req_add_sums_row_sparse_gradients():
    """A Gluon ``Embedding(sparse_grad=True)`` with ``grad_req="add"``:
    two backward passes' rows summed, equal in both packages; the port's
    gradient stays row-sparse (the JAX package scatters into a dense
    buffer, stated here) and ``zero_grad`` empties it."""
    table = np.random.RandomState(8).randn(6, 2).astype(np.float32)

    def run(mx, sp):
        emb = mx.gluon.nn.Embedding(6, 2, sparse_grad=True)
        emb.initialize()
        emb.weight.set_data(mx.nd.array(table))
        emb.collect_params().setattr("grad_req", "add")
        for ids in ([1, 3], [3, 4]):
            with mx.autograd.record():
                y = emb(mx.nd.array(np.array(ids, np.float32)))
            y.backward()
        g = emb.weight.grad()
        stype, dense = g.stype, g.asnumpy()
        emb.collect_params().zero_grad()
        return stype, dense, emb.weight.grad().asnumpy()

    (js, jg, jz), (ts, tg, tz) = _both(run)
    assert (ts, js) == ("row_sparse", "default")
    _same(tg, jg, exact=True)
    _same(tz, jz, exact=True)
    assert not tz.any()


def test_attach_grad_row_sparse_and_autograd_grad():
    """``attach_grad(stype="row_sparse")`` starts from an empty row-sparse
    gradient, and ``autograd.grad`` gives a row-sparse gradient for a
    sparse Embedding's weight (port-only: the JAX package keeps a dense
    buffer for the first and has no sparse route for the second)."""
    w = tmx.nd.array(np.ones((5, 2), np.float32))
    w.attach_grad(stype="row_sparse")
    assert w.grad.stype == "row_sparse" and w.grad.indices.shape == (0,)
    with tmx.autograd.record():
        y = tmx.nd.Embedding(tmx.nd.array([2.0, 2.0]), w, input_dim=5,
                             output_dim=2, sparse_grad=True)
    (g,) = tmx.autograd.grad([y], [w])
    assert g.stype == "row_sparse" and g.indices.asnumpy().tolist() == [2]
    _same(g.values.asnumpy(), [[2.0, 2.0]], exact=True)
    # "add" onto a row-sparse buffer sums row-sparse gradients, compacted
    w.attach_grad(grad_req="add", stype="row_sparse")
    for ids in ([3.0, 1.0], [1.0]):
        with tmx.autograd.record():
            y = tmx.nd.Embedding(tmx.nd.array(ids), w, input_dim=5,
                                 output_dim=2, sparse_grad=True)
        y.backward()
    assert w.grad.stype == "row_sparse"
    assert w.grad.indices.asnumpy().tolist() == [1, 3]
    _same(w.grad.values.asnumpy(), [[2.0, 2.0], [1.0, 1.0]], exact=True)
    w.zero_grad()
    assert w.grad.stype == "row_sparse" and w.grad.indices.shape == (0,)
    with pytest.raises(MXNetError):
        w.attach_grad(stype="csr")


def test_interior_weight_gets_a_dense_gradient():
    """A row-sparse cotangent into an interior node densifies, in both
    packages: the leaf under ``w * 2`` gets a dense gradient."""
    def run(mx, sp):
        w = mx.nd.array(np.ones((4, 2), np.float32))
        w.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Embedding(mx.nd.array([1.0, 1.0]), w * 2.0,
                                input_dim=4, output_dim=2, sparse_grad=True)
        y.backward()
        assert w.grad.stype == "default"
        return w.grad.asnumpy()

    a, b = _both(run)
    _same(b, a, exact=True)


def test_trainer_keeps_dense_parameters_on_the_dense_path():
    """In one Trainer step the sparse table takes the lazy update and the
    dense layer the multi-tensor one; the same three steps in both
    packages."""
    rs = np.random.RandomState(9)
    ids = rs.randint(0, 30, (8, 3)).astype(np.float32)
    y = rs.randn(8, 1).astype(np.float32)
    table = rs.randn(30, 4).astype(np.float32)
    dense_w = rs.randn(1, 12).astype(np.float32)

    def run(mx, sp):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Embedding(30, 4, sparse_grad=True),
                mx.gluon.nn.Flatten(), mx.gluon.nn.Dense(1, in_units=12))
        net.initialize()
        net[0].weight.set_data(mx.nd.array(table))
        net[2].weight.set_data(mx.nd.array(dense_w))
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.05, "wd": 0.01})
        for _ in range(3):
            with mx.autograd.record():
                loss = mx.gluon.loss.L2Loss()(net(mx.nd.array(ids)),
                                              mx.nd.array(y))
            loss.backward()
            trainer.step(8)
        return [net[0].weight.data().asnumpy(),
                net[2].weight.data().asnumpy(),
                net[2].bias.data().asnumpy()]

    for a, b in zip(*_both(run)):
        _same(b, a)


def test_sparse_update_ops_on_dense_inputs():
    """``_sparse_adagrad_update`` and ``_contrib_group_adagrad_update`` on
    dense inputs against the JAX package's; a RowSparseNDArray raises
    here (the JAX package's op takes none either)."""
    rs = np.random.RandomState(10)
    w0 = rs.randn(5, 3).astype(np.float32)
    g0 = rs.randn(5, 3).astype(np.float32)
    h0 = rs.rand(5, 3).astype(np.float32)
    hg0 = rs.rand(5).astype(np.float32)
    kw = dict(lr=0.2, rescale_grad=0.5, clip_gradient=0.4)

    jw, jh = jmx.nd._sparse_adagrad_update(
        jmx.nd.array(w0), jmx.nd.array(g0), jmx.nd.array(h0), epsilon=1e-6,
        **kw)
    tw, th = tmx.nd.array(w0), tmx.nd.array(h0)
    tmx.nd._sparse_adagrad_update(tw, tmx.nd.array(g0), th, epsilon=1e-6,
                                  **kw)
    _same(tw.asnumpy(), jw.asnumpy())
    _same(th.asnumpy(), jh.asnumpy())
    jw, jh = jmx.nd._contrib_group_adagrad_update(
        jmx.nd.array(w0), jmx.nd.array(g0), jmx.nd.array(hg0), **kw)
    tw, th = tmx.nd.array(w0), tmx.nd.array(hg0)
    tmx.nd._contrib_group_adagrad_update(tw, tmx.nd.array(g0), th, **kw)
    _same(tw.asnumpy(), jw.asnumpy())
    _same(th.asnumpy(), jh.asnumpy())
    for mx in (jmx, tmx):
        with pytest.raises(ValueError, match="wd must be 0"):
            mx.nd._sparse_adagrad_update(mx.nd.array(w0), mx.nd.array(g0),
                                         mx.nd.array(h0), wd=0.1)
    with pytest.raises(MXNetError, match="dense"):
        tmx.nd._sparse_adagrad_update(
            tmx.nd.array(w0), tsparse.row_sparse_array(g0),
            tmx.nd.array(h0))


def test_dgl_edge_id_and_adjacency():
    adj = np.array([[0, 2, 0, 5], [1, 0, 0, 0], [0, 3, 4, 0],
                    [0, 0, 0, 0]], np.float32)
    u = np.array([0, 0, 1, 2, 3, 2], np.float32)
    v = np.array([1, 2, 0, 2, 3, 1], np.float32)

    def run(mx, sp):
        csr = sp.csr_matrix(adj)
        eid = mx.nd.contrib.edge_id(csr, mx.nd.array(u), mx.nd.array(v))
        a = mx.nd.contrib.dgl_adjacency(csr)
        assert isinstance(a, sp.CSRNDArray)
        return eid.asnumpy(), a.asnumpy(), a.indices.asnumpy()

    (je, ja, jc), (te, ta, tc) = _both(run)
    _same(te, je, exact=True)
    _same(te, [2, -1, 1, 4, -1, 3], exact=True)
    _same(ta, ja, exact=True)
    _same(tc, jc, exact=True)


def test_sparse_arrays_keep_their_context_and_index_width():
    """Sparse arrays live on their context; indices are int64 here (the
    JAX package narrows them to int32)."""
    rsp = tsparse.row_sparse_array(np.eye(3, dtype=np.float32))
    csr = tsparse.csr_matrix(np.eye(3, dtype=np.float32))
    assert rsp.context == tmx.cpu() and csr.context == tmx.cpu()
    for a in (rsp.indices, csr.indices, csr.indptr):
        assert a.dtype == np.int64
    assert tsparse.zeros("csr", (2, 4)).asnumpy().shape == (2, 4)
    assert tmx.nd.array(np.eye(2)).tostype("row_sparse").stype \
        == "row_sparse"


# -- the slice as a whole, at small size -----------------------------------


class _MF:
    """``examples/recommenders/train_mf.py``'s MFNet for package ``mx``."""

    @staticmethod
    def net(mx, users, items, dim):
        class MFNet(mx.gluon.Block):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.user = mx.gluon.nn.Embedding(users, dim,
                                                      sparse_grad=True)
                    self.item = mx.gluon.nn.Embedding(items, dim,
                                                      sparse_grad=True)

            def forward(self, u, i):
                return (self.user(u) * self.item(i)).sum(axis=-1)

        return MFNet()


def test_matrix_factorization_matches_jax(tmp_path):
    """MFNet (50 users, 60 items, dim 8) trained 5 AdaGrad steps (lr 1.0)
    from the JAX net's weights: the losses and both tables agree, and
    each step's gradients are row-sparse."""
    rs = np.random.RandomState(11)
    tu, tv = rs.randn(50, 3), rs.randn(60, 3)
    batches = []
    for _ in range(5):
        u, i = rs.randint(0, 50, 32), rs.randint(0, 60, 32)
        r = (tu[u] * tv[i]).sum(1) / np.sqrt(3) + 0.05 * rs.randn(32)
        batches.append((u.astype(np.float32), i.astype(np.float32),
                        r.astype(np.float32)))
    jmx.random.seed(0)
    jnet = _MF.net(jmx, 50, 60, 8)
    jnet.initialize(jmx.init.Normal(0.1))
    f = str(tmp_path / "mf.params")
    jnet.save_parameters(f)

    def run(mx, sp):
        net = _MF.net(mx, 50, 60, 8)
        net.initialize()
        net.load_parameters(f)
        trainer = mx.gluon.Trainer(net.collect_params(), "adagrad",
                                   {"learning_rate": 1.0})
        loss_fn = mx.gluon.loss.L2Loss()
        losses = []
        for u, i, r in batches:
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(u), mx.nd.array(i)),
                               mx.nd.array(r))
            loss.backward()
            assert net.user.weight.grad().stype == "row_sparse"
            trainer.step(len(r))
            losses.append(float(loss.mean().asnumpy()))
        return losses, net.user.weight.data().asnumpy(), \
            net.item.weight.data().asnumpy()

    (jl, ju, ji), (tl, tu_, ti) = _both(run)
    _same(tl, jl, tol=TRAINED)
    _same(tu_, ju, tol=TRAINED)
    _same(ti, ji, tol=TRAINED)


def test_sparse_embedding_net_matches_jax(tmp_path):
    """``examples/sparse/sparse_embedding.py``'s net (``SparseEmbedding``,
    ``Flatten``, ``Dense(1)``) at vocab 200, dim 8: 5 Adam steps from the
    JAX net's weights, losses and weights agree."""
    rs = np.random.RandomState(12)
    hidden = rs.randn(200).astype(np.float32) * 0.3
    batches = []
    for _ in range(5):
        ids = rs.randint(0, 200, (16, 8)).astype(np.float32)
        batches.append((ids, (hidden[ids.astype(int)].sum(1) > 0)
                        .astype(np.float32)))

    def build(mx):
        from importlib import import_module

        cnn = import_module(mx.__name__ + ".gluon.contrib.nn")
        net = mx.gluon.nn.HybridSequential()
        net.add(cnn.SparseEmbedding(200, 8))
        net.add(mx.gluon.nn.Flatten(), mx.gluon.nn.Dense(1))
        return net

    jmx.random.seed(0)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(batches[0][0]))
    f = str(tmp_path / "emb.params")
    jnet.save_parameters(f)

    def run(mx, sp):
        net = build(mx)
        net.initialize()
        net(mx.nd.array(batches[0][0]))
        net.load_parameters(f)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.05})
        loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        losses = []
        for ids, y in batches:
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(ids)).reshape((-1,)),
                               mx.nd.array(y))
            loss.backward()
            assert net[0].weight.grad().stype == "row_sparse"
            trainer.step(ids.shape[0])
            losses.append(float(loss.mean().asnumpy()))
        return [losses] + [p.data().asnumpy() for p in
                           net.collect_params().values()]

    for a, b in zip(*_both(run)):
        _same(b, a, tol=TRAINED)


def test_linear_classification_matches_jax():
    """``examples/sparse/linear_classification.py``'s loop on the
    committed ``examples/sparse/data/train.libsvm`` (200 examples, 50
    features, batch 32), 3 epochs: ``LibSVMIter`` CSR batches, the
    forward ``sparse.dot(x, w)`` and the gradient ``sparse.dot(x, err,
    transpose_a=True)``; the epoch losses and the weight agree."""
    path = os.path.join(REPO, "examples", "sparse", "data", "train.libsvm")

    def run(mx, sp):
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(50,),
                              batch_size=32)
        w, b, losses = mx.nd.zeros((50, 1)), 0.0, []
        for _ in range(3):
            it.reset()
            total = []
            for batch in it:
                x = batch.data[0]
                assert x.stype == "csr"
                y = batch.label[0].asnumpy()
                p = 1.0 / (1.0 + np.exp(-(sp.dot(x, w).asnumpy()
                                          .reshape(-1) + b)))
                err = (p - y).astype(np.float32)
                keep = len(y) - batch.pad
                total.append(-np.mean(
                    y[:keep] * np.log(p[:keep] + 1e-7)
                    + (1 - y[:keep]) * np.log(1 - p[:keep] + 1e-7)))
                gw = sp.dot(x, mx.nd.array(err.reshape(-1, 1)),
                            transpose_a=True)
                w = mx.nd.array(w.asnumpy() - 0.5 * gw.asnumpy() / len(y))
                b -= 0.5 * float(err.mean())
            losses.append(float(np.mean(total)))
        return losses, w.asnumpy()

    (jl, jw), (tl, tw) = _both(run)
    assert tl[-1] < tl[0]
    _same(tl, jl, tol=TRAINED)
    _same(tw, jw, tol=TRAINED)


def test_csr_dot_plain_version_shapes_and_errors():
    """O7's wrapper on the host: rows with no nonzeros, an empty matrix,
    K > 1, and a right operand of the wrong height raising."""
    from mxnet_tpu_torch.ops import sparse_ops as sops

    data = torch.tensor([1.0, 2.0, 3.0])
    indptr = torch.tensor([0, 0, 2, 2, 3])
    cols = torch.tensor([1, 4, 0])
    dense = np.zeros((4, 5), np.float32)
    dense[1, 1], dense[1, 4], dense[3, 0] = 1, 2, 3
    rhs = torch.randn(5, 6)
    _same(sops.csr_dot(data, indptr, cols, rhs, (4, 5)).numpy(),
          dense @ rhs.numpy())
    rhs_t = torch.randn(4, 6)
    _same(sops.csr_dot(data, indptr, cols, rhs_t, (4, 5), True).numpy(),
          dense.T @ rhs_t.numpy())
    empty = sops.csr_dot(torch.zeros(0), torch.zeros(4, dtype=torch.int64),
                         torch.zeros(0, dtype=torch.int64), torch.ones(7, 2),
                         (3, 7))
    _same(empty.numpy(), np.zeros((3, 2)), exact=True)
    with pytest.raises(MXNetError):
        sops.csr_dot(data, indptr, cols, torch.ones(4, 1), (4, 5))
