"""Engine bulking of the port (``mxnet_tpu_torch.engine.BulkSegment``,
``ops.registry._try_bulk``) against the JAX package's, on the CPU.

Each case is named after its counterpart in ``tests/test_bulk_engine.py``.
The same seeded numpy inputs go through both packages' ``mx.nd`` with
bulking on; the port's bulked results must be bitwise equal to its own
eager results (``engine.bulk(0)``) and agree with the JAX package's
within the stated tolerance (``rtol=1e-5``: XLA fuses a segment's
multiply and add into one rounding, torch rounds each op).  On the host a segment
flushes by running its ops in order; the card replays it as a CUDA
graph (``tests/test_torch_kernels_cuda.py``).
"""
import collections

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, engine, graph_cache
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.engine import Engine
from mxnet_tpu_torch.ops import registry

nd = tmx.nd


@pytest.fixture(autouse=True)
def host():
    with tmx.cpu():
        yield


@pytest.fixture
def eng():
    e = Engine.get()
    e.flush_bulk("test_setup")
    return e


@pytest.fixture
def fresh_engine(monkeypatch):
    """Build the engine anew (it reads its knobs when made)."""
    old = Engine._instance

    def make(**env):
        for k in ("MXNET_ENGINE_TYPE", "MXNET_EXEC_BULK_EXEC_MAX_NODE",
                  "MXNET_EXEC_BULK_EXEC_TRAIN",
                  "MXNET_EXEC_BULK_EXEC_INFERENCE", "MXNET_PROFILE_BULK",
                  "MXNET_EXEC_BULK_DONATE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        Engine._instance = None
        return Engine.get()

    yield make
    Engine._instance = old


def _chain(x, n=20):
    y = x
    for i in range(n):
        y = (y + 1.0) if i % 2 else (y * 1.5)
    return y


def _x(seed=0, shape=(8, 8)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_20_op_chain_is_one_push_bit_identical(eng):
    xv = _x()
    x = nd.array(xv)
    with engine.bulk(0):
        ref = _chain(x).asnumpy()           # eager
    p0, b0, s0 = (eng.stats.ops_pushed, eng.stats.bulk_ops,
                  eng.stats.bulk_segments)
    with engine.bulk(32):
        y = _chain(x)
        assert eng.stats.ops_pushed == p0, "the chain was not deferred"
        assert y._pending is not None
    out = y.asnumpy()
    assert eng.stats.ops_pushed == p0 + 1
    assert eng.stats.bulk_ops == b0 + 20
    assert eng.stats.bulk_segments == s0 + 1
    assert np.array_equal(out, ref), "bulked differs bitwise from eager"
    with jengine.bulk(32):
        want = _chain(jnd.array(xv)).asnumpy()
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_lazy_ndarray_carries_aval_without_flushing(eng):
    with engine.bulk(16):
        y = nd.ones((3, 4), dtype="float32") + 1.0
        z = y.astype("bfloat16").sum(axis=1)
        p0 = eng.stats.ops_pushed
        assert y.shape == (3, 4) and str(y.dtype) == "float32"
        assert y.size == 12 and y.ndim == 2 and len(y) == 3
        assert z.shape == (3,) and z.dtype == torch.bfloat16
        assert eng.stats.ops_pushed == p0
    with jengine.bulk(16):
        jy = jnd.ones((3, 4), dtype="float32") + 1.0
        assert jy.shape == y.shape and str(jy.dtype) == str(y.dtype)


@pytest.mark.parametrize("sync", [
    "asnumpy", "wait_to_read", "waitall", "float", "bool", "getitem",
    "setitem", "repr", "array",
])
def test_segment_flushes_at_every_sync_point(eng, sync):
    with engine.bulk(64):
        y = (nd.ones((2, 2)) + 1.0) * 2.0
        p0 = eng.stats.ops_pushed
        if sync == "asnumpy":
            y.asnumpy()
        elif sync == "wait_to_read":
            y.wait_to_read()
        elif sync == "waitall":
            tmx.nd.waitall()
        elif sync == "float":
            float(y.sum())
        elif sync == "bool":
            bool(y.sum() > 0)
        elif sync == "getitem":
            y[0, 0].asnumpy()
        elif sync == "setitem":
            y[0, 0] = 7.0
        elif sync == "repr":
            repr(y)
        elif sync == "array":
            np.asarray(y)
        assert eng.stats.ops_pushed > p0, "%s did not flush" % sync
        assert y._pending is None or y._pending.value is not None
        assert np.asarray(y._data).flat[-1] == 4.0


def _recorded_chain(mx_, bulk, x_np, cap, n=20):
    x = mx_.nd.array(x_np)
    x.attach_grad()
    with bulk(cap):
        with mx_.autograd.record():
            y = x
            for i in range(n):
                y = y * 1.25 if i % 2 == 0 else y + 0.5
            loss = (y * y).sum()
        loss.backward()
    return x.grad.asnumpy(), y.asnumpy(), float(loss.asnumpy())


def test_recorded_20op_chain_one_segment_bitwise_grads(eng):
    xv = _x(11)
    g_eager, y_eager, l_eager = _recorded_chain(tmx, engine.bulk, xv, 0)
    s0 = eng.stats.bulk_segments
    g_bulk, y_bulk, l_bulk = _recorded_chain(tmx, engine.bulk, xv, 64)
    assert eng.stats.bulk_segments == s0 + 1, \
        "chain and loss are one segment, flushed by backward"
    assert np.array_equal(y_bulk, y_eager) and l_bulk == l_eager
    assert np.array_equal(g_bulk, g_eager), \
        "gradients through a bulked forward differ bitwise from eager"
    g_jax, y_jax, l_jax = _recorded_chain(jmx, jengine.bulk, xv, 64)
    np.testing.assert_allclose(y_bulk, y_jax, rtol=1e-5)
    np.testing.assert_allclose(g_bulk, g_jax, rtol=1e-5)
    np.testing.assert_allclose(l_bulk, l_jax, rtol=1e-5)


def test_recorded_mixed_ops_bitwise_grads(eng):
    rs = np.random.RandomState(3)
    xv, wv = (rs.randn(8, 8).astype(np.float32) for _ in range(2))

    def run(mx_, bulk, cap):
        x, w = mx_.nd.array(xv), mx_.nd.array(wv)
        x.attach_grad()
        w.attach_grad()
        with bulk(cap):
            with mx_.autograd.record():
                h = mx_.nd.tanh(mx_.nd.dot(x, w)) * 1.25 + 0.5
                loss = (h * h).sum()
            loss.backward()
        return x.grad.asnumpy(), w.grad.asnumpy()

    ge, gb = run(tmx, engine.bulk, 0), run(tmx, engine.bulk, 64)
    assert all(np.array_equal(a, b) for a, b in zip(ge, gb))
    for a, b in zip(gb, run(jmx, jengine.bulk, 64)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_var_version_bumps_match_eager(eng):
    a = nd.ones((2, 2))
    v0 = a._var.version
    with engine.bulk(16):
        a += 1.0            # in place: runs now, the version bumps
        assert a._var.version == v0 + 1
        a *= 2.0
        assert a._var.version == v0 + 2
        dst = nd.zeros((2, 2))
        d0 = dst._var.version
        nd.broadcast_add(a, a, out=dst)
        assert dst._var.version == d0 + 1
        b = a * 3.0         # deferred: a new array, a's version stays
        assert a._var.version == v0 + 2 and b._var.version == 0
    np.testing.assert_allclose(a.asnumpy(), 4.0)
    np.testing.assert_allclose(dst.asnumpy(), 8.0)
    np.testing.assert_allclose(b.asnumpy(), 12.0)


def test_failed_segment_poisons_all_outputs(eng, monkeypatch):
    orig = Engine.push

    def failing(self, fn, *args, **kwargs):
        if (kwargs.get("op_name") or "").startswith("bulk_segment["):
            raise RuntimeError("segment boom")
        return orig(self, fn, *args, **kwargs)

    monkeypatch.setattr(Engine, "push", failing)
    with engine.bulk(16):
        a = nd.ones((2,)) + 1.0
        b = a * 3.0
        with pytest.raises(RuntimeError, match="segment boom"):
            b.asnumpy()
        with pytest.raises(RuntimeError, match="segment boom"):
            a.asnumpy()     # the sibling's var was poisoned
        with pytest.raises(MXNetError, match="deferred NDArray lost"):
            a.asnumpy()


def test_segment_cache_no_retrace_on_repeat(eng):
    def step(x):
        with engine.bulk(16):
            y = x
            for _ in range(5):
                y = y * 2.0 + 1.0
        return y.asnumpy()

    x = nd.ones((4, 4))
    r1 = step(x)
    n1 = engine.bulk_build_count()
    r2 = step(x)
    assert engine.bulk_build_count() == n1, "a repeated op stream rebuilt"
    assert np.array_equal(r1, r2)
    step(nd.ones((2, 2)))       # new input shapes: a new key
    assert engine.bulk_build_count() == n1 + 1


def test_max_node_cap_splits_segments(eng):
    x = nd.ones((4,))
    x.wait_to_read()
    p0 = eng.stats.ops_pushed
    with engine.bulk(4):
        z = _chain(x, n=10)
    z.wait_to_read()
    assert eng.stats.ops_pushed - p0 == 3       # 4 + 4 + 2 ops
    np.testing.assert_array_equal(
        z.asnumpy(), _chain(jnd.ones((4,)), n=10).asnumpy())


@pytest.mark.parametrize("knobs,pushes", [
    ({}, 2),                                          # BulkEngine, 64
    ({"MXNET_EXEC_BULK_EXEC_MAX_NODE": "15"}, 5),     # 15 + 15 + 15 + 15 + 10
    ({"MXNET_ENGINE_TYPE": "NaiveEngine"}, 70),
    ({"MXNET_EXEC_BULK_EXEC_INFERENCE": "0"}, 70),
    ({"MXNET_EXEC_BULK_EXEC_TRAIN": "0"}, 2),         # not in train mode
    ({"MXNET_EXEC_BULK_DONATE": "0"}, 2),             # accepted, no effect
])
def test_bulk_engine_env_selection(fresh_engine, knobs, pushes):
    e = fresh_engine(**knobs)
    assert e.kind == knobs.get("MXNET_ENGINE_TYPE", "BulkEngine")
    x = nd.ones((3,))
    x.wait_to_read()
    p0 = e.stats.ops_pushed
    y = _chain(x, n=70)
    y.wait_to_read()
    assert e.stats.ops_pushed - p0 == pushes
    with engine.bulk(0):
        np.testing.assert_array_equal(y.asnumpy(), _chain(x, n=70).asnumpy())


def test_bulk_engine_train_knob_under_train_mode(fresh_engine):
    e = fresh_engine(MXNET_EXEC_BULK_EXEC_TRAIN="0")
    x = nd.ones((3,))
    x.wait_to_read()
    p0 = e.stats.ops_pushed
    with autograd.train_mode():
        _chain(x, n=4).wait_to_read()
    assert e.stats.ops_pushed - p0 == 4


def test_nested_bulk_zero_flushes_pending(eng):
    with engine.bulk(16):
        a = nd.ones((3,)) + 1.0     # ones runs eagerly; +1.0 defers
        p1 = eng.stats.ops_pushed
        with engine.bulk(0):
            assert eng.stats.ops_pushed == p1 + 1, \
                "entering bulk(0) must flush the pending segment"
            b = a * 2.0
            assert eng.stats.ops_pushed == p1 + 2
        c = b + 1.0                 # the outer scope defers again
        assert eng.stats.ops_pushed == p1 + 2
    np.testing.assert_allclose(c.asnumpy(), 5.0)


def test_set_bulk_size_zero_flushes_pending(fresh_engine):
    e = fresh_engine()
    x = nd.ones((3,))
    x.wait_to_read()
    p0 = e.stats.ops_pushed
    y = x + 1.0
    assert e.stats.ops_pushed == p0
    prev = engine.set_bulk_size(0)
    assert e.stats.ops_pushed == p0 + 1, \
        "set_bulk_size(0) must flush the pending segment"
    z = y * 2.0
    assert e.stats.ops_pushed == p0 + 2
    engine.set_bulk_size(prev)
    np.testing.assert_allclose(z.asnumpy(), 4.0)


def test_profile_bulk_env_keeps_segments_fused(fresh_engine):
    e = fresh_engine(MXNET_PROFILE_BULK="1")
    seen = []
    hook = lambda name, t0, t1: seen.append(name)     # noqa: E731
    x = nd.ones((4,))
    x.wait_to_read()
    e.add_hook(hook)
    try:
        _chain(x, n=6).wait_to_read()
    finally:
        e.remove_hook(hook)
    assert seen == ["bulk_segment[6]"]


def test_rng_ops_flush_and_run_eagerly(eng):
    name = "_test_random_uniform"
    registry.register(name, needs_rng=True)(
        lambda x: torch.rand(x.shape, dtype=x.dtype, device=x.device))
    try:
        with engine.bulk(16):
            a = nd.ones((4,)) + 1.0
            p0 = eng.stats.ops_pushed
            r = registry.invoke(name, [a])
            # the open segment flushed, then the rng op ran eagerly
            assert eng.stats.ops_pushed == p0 + 2
            assert a._pending is None or a._pending.value is not None
            assert r._pending is None
        assert r.shape == (4,)
    finally:
        del registry._REGISTRY[name]


def test_deferred_value_survives_source_overwrite(eng):
    # an op reads its input's value when it is called, also when the
    # port's in-place write lands before the segment flushes
    av = np.ones(3, np.float32)
    a = nd.array(av)
    with engine.bulk(16):
        b = a + 1.0
        a[:] = 100.0
        c = b * 2.0
        d = a * 1.0
        a += 1.0            # in place again, with c and d pending
    np.testing.assert_allclose(c.asnumpy(), 4.0)
    np.testing.assert_allclose(d.asnumpy(), 100.0)
    np.testing.assert_allclose(a.asnumpy(), 101.0)
    ja = jnd.array(av)
    with jengine.bulk(16):
        jb = ja + 1.0
        ja[:] = 100.0
        jc = jb * 2.0
    np.testing.assert_array_equal(c.asnumpy(), jc.asnumpy())


OPWAVE_CASES = [
    ("elemwise", lambda x: ((x + 1.5) * 2.0 - 0.25) / 3.0),
    ("unary", lambda x: x.abs().sqrt().exp().tanh()),
    ("reduce", lambda x: x.sum(axis=1, keepdims=True) + x.mean()),
    ("matmul", lambda x: x.dot(x.T) * 0.1),
    ("shape", lambda x: (x.reshape(-1).expand_dims(0).squeeze(0)
                         .reshape(4, 6).transpose())),
    ("compare", lambda x: (x > 0.2) * x + x.clip(-0.5, 0.5)),
    ("mixed", lambda x: (x.relu() + x.sigmoid()).sum(axis=0).square()),
]


@pytest.mark.parametrize("name,fn", OPWAVE_CASES,
                         ids=[c[0] for c in OPWAVE_CASES])
def test_bulked_numerics_identical_to_eager(eng, name, fn):
    xv = np.random.RandomState(42).randn(4, 6).astype(np.float32)
    x = nd.array(xv)
    with engine.bulk(0):
        ref = fn(x).asnumpy()
    s0 = eng.stats.bulk_segments
    with engine.bulk(64):
        lazy = fn(x)
    out = lazy.asnumpy()
    assert eng.stats.bulk_segments > s0
    assert np.array_equal(out, ref), \
        "op wave %r: bulked differs bitwise from eager" % name
    np.testing.assert_allclose(out, fn(jnd.array(xv)).asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_segment_cache_tier_eviction(eng, monkeypatch):
    monkeypatch.setattr(engine, "_SEG_TIER_BUDGETS", (1, 1, 1, 1))
    st = eng._bulk_state()
    monkeypatch.setattr(st, "tiers",
                        tuple(collections.OrderedDict() for _ in range(4)))
    stats = tuple({"hits": 0, "misses": 0, "evictions": 0}
                  for _ in range(4))
    monkeypatch.setattr(engine, "_seg_tier_stats", stats)

    def run(mult):
        with engine.bulk(8):
            y = nd.ones((4,)) * mult + 1.0
        y.wait_to_read()
        return y.asnumpy()

    run(2.0)
    run(2.0)   # same structure: a hit in the le8 tier
    assert stats[0]["hits"] == 1 and stats[0]["misses"] == 1
    run(3.0)   # other attrs: a new key evicts the old (budget 1)
    assert stats[0]["evictions"] == 1
    np.testing.assert_array_equal(run(2.0), 3.0)   # evicted: misses again
    assert stats[0]["misses"] == 3
    assert len(st.tiers[0]) == 1


def test_tier_budget_env_knob(monkeypatch):
    monkeypatch.setenv("MXNET_EXEC_BULK_SEG_CACHE_BUDGETS", "2,3,4,5")
    assert engine._parse_tier_budgets() == (2, 3, 4, 5) \
        == jengine._parse_tier_budgets()
    monkeypatch.delenv("MXNET_EXEC_BULK_SEG_CACHE_BUDGETS")
    assert engine._parse_tier_budgets() == (128, 64, 32, 32) \
        == jengine._parse_tier_budgets()


def _host_pairs(monkeypatch):
    """Run recorded segments as graph pairs on the host, which capture
    their graphs' card-free doubles (eager runs in place of replays)."""
    made = []

    def executable(fn, device, recorded, stream, pool, label, stable):
        if not recorded:
            return fn
        made.append(graph_cache.RecordedCall(fn, device, label=label,
                                             inplace=stable))
        return made[-1]

    monkeypatch.setattr(engine, "_executable", executable)
    return made


def test_recorded_segment_pair_busy_rule_gives_eager_grads(eng,
                                                           monkeypatch):
    """Gradient accumulation over two recorded forwards of one segment
    key, then one backward: the second forward finds the pair busy and
    runs eagerly, and the gradients equal the eager ones bitwise."""
    made = _host_pairs(monkeypatch)
    xs = [_x(s, (4, 4)) for s in (1, 2)]

    def run(cap, steps=3):
        w = nd.array(_x(0, (4, 4)))
        w.attach_grad(grad_req="add")
        for _ in range(steps):
            with engine.bulk(cap):
                with autograd.record():
                    losses = [((w * nd.array(x) + 0.5) ** 2.0).sum()
                              for x in xs]
                autograd.backward(losses)
        return w.grad.asnumpy()

    want = run(0)
    got = run(4)        # each loss's 4 ops flush as one segment
    assert np.array_equal(got, want)
    (pair,) = made
    assert pair.captures == 1 and pair.busy_calls >= 2 \
        and pair.backward_replays >= 1


def test_create_graph_through_a_graphed_segment_raises(eng, monkeypatch):
    _host_pairs(monkeypatch)
    x = nd.array(_x(5, (4, 4)))
    x.attach_grad()
    for i in range(3):
        with engine.bulk(16):
            with autograd.record():
                loss = (x * x * x).sum()
        if i < 2:
            loss.backward()     # first call eager, then captured
            continue
        with pytest.raises(MXNetError, match="create_graph=True"):
            autograd.grad(loss, [x], create_graph=True)


def test_function_and_out_flush_and_run_eagerly(eng):
    class Twice(autograd.Function):
        def forward(self, a):
            return a * 2.0

        def backward(self, g):
            return g * 2.0

    with engine.bulk(16):
        a = nd.ones((3,)) + 1.0
        p0 = eng.stats.ops_pushed
        b = Twice()(a)
        assert eng.stats.ops_pushed >= p0 + 1
        assert a._pending is None or a._pending.value is not None
        dst = nd.zeros((3,))
        buf = dst._data
        c = b + 1.0
        nd.broadcast_add(c, c, out=dst)     # out=: flushes, in place
        assert dst._data is buf and c._pending is None \
            or c._pending.value is not None
    np.testing.assert_allclose(dst.asnumpy(), 10.0)
