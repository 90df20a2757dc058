"""The port's compiled paths against the JAX package's, on the CPU.

``HybridBlock.hybridize()`` and the serve runner run each call signature
as one captured CUDA graph on the card (``mxnet_tpu_torch.graph_cache``);
on the CPU they run eagerly, and the keying and invalidation rules are
the same.  Here:

- the port's hybridized ``llama_small`` against the JAX package's
  hybridized block (weights carried across with ``load_jax_params``)
  over calls 1, 2 and 3, a new input shape, an in-place parameter
  update, ``cast("bfloat16")`` and ``hybridize(False)``: f32 logits to
  rtol 1e-4 / atol 1e-4 (as ``test_torch_llama.py``), bf16 within 0.1
  of the JAX package's bf16 logits (a few bf16 ulps);
- greedy tokens of a ``TorchRunner(graphs=True)`` server on a CPU arena
  equal to the JAX package's server over live-jitted step functions;
- the signature, storage and launch-count rules as plain functions.

The graphs themselves run on the card: ``tests/test_torch_kernels_cuda.py``.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo import llama as jllama
from mxnet_tpu.serve import Request as JaxRequest
from mxnet_tpu.serve import arena as jax_arena
from mxnet_tpu.serve import model as jm
from mxnet_tpu.serve import server as jax_server
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import compile_cache as tcc
from mxnet_tpu_torch import graph_cache as gc
from mxnet_tpu_torch import serve as ts
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.block import HybridBlock
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.serve import model as tm

TOL = dict(rtol=1e-4, atol=1e-4)


def _twins(seed, toks):
    mx.random.seed(seed)
    jnet = jllama.llama_small()
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(toks))                      # resolves deferred shapes
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = tllama.llama_small(device="cpu")
    tllama.load_jax_params(net, params)
    return jnet, net


def _host_pairs(net):
    """Run ``net``'s recorded calls as graph pairs on the host: the pair
    then captures its graphs' host doubles (eager runs in place of the
    replays)."""
    net._graphs.pairs_on = lambda device: True


def _both(jnet, net, toks):
    want = jnet(nd.array(toks)).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(toks))
    return got, want


def test_hybridized_llama_matches_jax_across_calls_and_invalidations():
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 512, (2, 16)).astype(np.float32)
    jnet, net = _twins(0, toks)
    jnet.hybridize()
    assert net.hybridize() is net
    assert all(b._active for b in net.modules()
               if isinstance(b, HybridBlock))
    for _ in range(3):                        # eager, then compiled
        got, want = _both(jnet, net, toks)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    key = gc.signature((torch.from_numpy(toks),), False)
    assert list(net._graphs.calls) == [key]
    assert net._graphs.calls[key].calls == 3
    assert net._graphs.calls[key].captures == 0, "no graph on the CPU"

    # a new input shape is a new signature
    toks2 = rs.randint(0, 512, (1, 24)).astype(np.float32)
    for _ in range(2):
        got, want = _both(jnet, net, toks2)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert len(net._graphs.calls) == 2

    # an in-place parameter update between calls
    delta = rs.standard_normal(64).astype(np.float32) * 0.1
    jp = jnet._collect_params_with_prefix()["norm.weight"]
    jp.set_data(jp.data() + nd.array(delta))
    with torch.no_grad():
        net.norm.weight.add_(torch.from_numpy(delta))
    got, want = _both(jnet, net, toks)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    # cast drops the cached calls on both sides
    jnet.cast("bfloat16")
    net.cast("bfloat16")
    assert net._graphs.calls == {}
    for _ in range(2):
        got, want = _both(jnet, net, toks)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=0.1)

    # hybridize(False) drops them and disarms every block
    jnet.hybridize(False)
    net.hybridize(False)
    assert net._graphs.calls == {} and not net._active
    got, want = _both(jnet, net, toks)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.1)
    assert net._graphs.calls == {}


def test_hybridize_keys_by_training_and_skips_recorded_calls():
    """Unrecorded calls key by signature and training flag; a recorded
    call runs eagerly on the host, and where recorded calls run as graph
    pairs (the card, or the host double) it keys also by which inputs
    and parameters require grad."""
    toks = np.random.RandomState(1).randint(0, 512, (1, 8)) \
        .astype(np.float32)
    _, net = _twins(1, toks)
    net.hybridize()
    x = torch.from_numpy(toks)
    out = net(x)                              # grad mode on: recorded
    assert out.requires_grad and net._graphs.calls == {}
    with torch.no_grad():
        net(x)
        with tag.train_mode():
            net(x)
    assert sorted(k[1] for k in net._graphs.calls) == [False, True]
    _host_pairs(net)
    out = net(x)
    assert out.requires_grad
    (rkey,) = [k for k in net._graphs.calls if len(k) == 4]
    n_params = len(list(net.parameters()))
    assert rkey[:2] == gc.signature((x,), False)
    assert rkey[2] == (False,) and rkey[3] == (True,) * n_params
    assert isinstance(net._graphs.calls[rkey], gc.RecordedCall)
    net.blocks[0].attn.q_proj.weight.requires_grad_(False)
    net(x)
    assert len([k for k in net._graphs.calls if len(k) == 4]) == 2, \
        "a parameter's grad flag is part of the key"
    net.blocks[0].attn.q_proj.weight.requires_grad_(True)
    inner = net.blocks[0]
    assert inner._active and inner._graphs.calls == {}, \
        "blocks called inside a hybridized call run with it"
    net.initialize(force_reinit=True)
    assert net._graphs.calls == {}
    with torch.no_grad():
        net(x)
    net.clear_cache()
    assert net._graphs.calls == {}


def _train(net, x, y, steps=3, hybrid=False):
    """``steps`` adam steps of gluon.Trainer under ``record()``, through
    the graph pair's host double where ``hybrid``."""
    from mxnet_tpu_torch import gluon as tgluon

    if hybrid:
        net.hybridize()
        _host_pairs(net)
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 1e-3})
    losses = []
    for _ in range(steps):
        with tag.record():
            loss = loss_fn(net(torch.from_numpy(x)).reshape(-1, 512),
                           torch.from_numpy(y).reshape(-1)).mean()
        loss.backward()
        trainer.step(1)
        losses.append(loss.item())
    return losses


def test_hybridized_llama_trained_under_record_matches_jax():
    """3 adam steps of gluon.Trainer over a hybridized llama_small under
    ``record()``: the JAX package's hybridized losses and weights within
    the tolerance of test_train's Trainer case (1e-4), and the port's
    graph pair (its host double: eager passes in place of the graphs)
    bitwise equal to the port's eager training."""
    from mxnet_tpu import autograd as jautograd
    from mxnet_tpu import gluon as jgluon

    rs = np.random.RandomState(8)
    x = rs.randint(0, 512, (2, 16)).astype(np.float32)
    y = rs.randint(0, 512, (2, 16)).astype(np.float32)
    jnet, eager = _twins(8, x)
    _, paired = _twins(8, x)
    jnet.hybridize()
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam",
                              {"learning_rate": 1e-3})
    want = []
    for _ in range(3):
        with jautograd.record():
            jl = jloss(jnet(nd.array(x)).reshape(-3, 0),
                       nd.array(y).reshape(-1)).mean()
        jl.backward()
        jtrainer.step(1)
        want.append(float(jl.asscalar()))
    got = _train(paired, x, y, hybrid=True)
    np.testing.assert_allclose(got, want, **TOL)
    jparams = jnet._collect_params_with_prefix()
    for name, p in paired.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jparams[name].data().asnumpy(),
                                   err_msg=name, **TOL)
    (pair,) = paired._graphs.calls.values()
    assert (pair.calls, pair.captures, pair.replays,
            pair.backward_replays) == (3, 1, 2, 2)
    assert _train(eager, x, y) == got
    for (name, a), b in zip(paired.named_parameters(), eager.parameters()):
        assert torch.equal(a, b), name


def test_two_recorded_forwards_then_one_backward_give_eager_grads():
    """Gradient accumulation: two recorded calls of one signature before
    one backward.  The second finds the pair busy and runs eagerly
    (counted), so the gradients equal the eager block's bitwise."""
    rs = np.random.RandomState(9)
    toks = [rs.randint(0, 512, (1, 8)).astype(np.float32) for _ in range(3)]
    _, net = _twins(9, toks[0])
    _, ref = _twins(9, toks[0])
    net.hybridize()
    _host_pairs(net)

    def grads(block, pairs):
        outs = [block(torch.from_numpy(t)) for t in pairs]
        loss = sum((o.float() ** 2).mean() for o in outs)
        return torch.autograd.grad(loss, list(block.parameters()))

    grads(net, toks[:1])                      # eager, then the capture
    grads(net, toks[:1])
    got = grads(net, toks[1:])
    want = grads(ref, toks[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st = net.stats()
    assert st["captures"] == 1 and st["busy_calls"] == 1
    assert st["replays"] == 2 and st["backward_replays"] == 2


def test_two_keys_interleaved_and_a_call_between_give_eager_grads():
    """Two recorded signatures whose backwards run in another order than
    their forwards, and an unrecorded call between a forward and its
    backward: each pair keeps what its backward reads (on the card in a
    pool of its own), so the gradients equal the eager block's bitwise
    and no call finds a pair busy."""
    rs = np.random.RandomState(12)
    xa = torch.from_numpy(rs.randint(0, 512, (1, 8)).astype(np.float32))
    xb = torch.from_numpy(rs.randint(0, 512, (2, 12)).astype(np.float32))
    _, net = _twins(12, xa.numpy())
    _, ref = _twins(12, xa.numpy())

    def head(out):
        return (out.float() ** 2).mean()

    def interleaved(block):
        params = list(block.parameters())
        lb, la = head(block(xb)), head(block(xa))
        return (torch.autograd.grad(la, params)
                + torch.autograd.grad(lb, params))

    def between(block):
        loss = head(block(xa))
        with torch.no_grad():
            block(xb)
        return torch.autograd.grad(loss, list(block.parameters()))

    want = interleaved(ref), between(ref)
    net.hybridize()
    _host_pairs(net)
    with torch.no_grad():
        for _ in range(2):
            net(xb)                           # the unrecorded call
    for x in (xa, xb):
        for _ in range(2):                    # each pair: eager, captured
            torch.autograd.grad(head(net(x)), list(net.parameters()))
    for _ in range(2):
        got = interleaved(net), between(net)
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w))
    st = net.stats()
    assert (st["captures"], st["busy_calls"]) == (2, 0)
    assert st["replays"] == 2 + 3 * 2 and st["backward_replays"] == 2 + 3 * 2


def test_in_place_change_before_the_backward_raises_as_eager_does():
    """A parameter changed in place between a graphed call's forward and
    its backward: eager autograd refuses the backward (a saved tensor
    changed), and so does the graph pair, whose backward graph would
    read the new value (shown on the pair's host double)."""
    toks = np.random.RandomState(11).randint(0, 512, (1, 8)) \
        .astype(np.float32)
    _, net = _twins(11, toks)
    x = torch.from_numpy(toks)
    params = list(net.parameters())
    weight = net.blocks[0].attn.q_proj.weight

    def backward_after_change():
        out = net(x).sum()
        with torch.no_grad():
            weight.mul_(1.0)
        torch.autograd.grad(out, params)

    with pytest.raises(RuntimeError, match="modified by an inplace"):
        backward_after_change()               # eager
    net.hybridize()
    _host_pairs(net)
    for _ in range(2):                        # eager, then captured
        torch.autograd.grad(net(x).sum(), params)
    with pytest.raises(MXNetError, match="modified in place"):
        backward_after_change()
    torch.autograd.grad(net(x).sum(), params)  # the pair is free again


def test_create_graph_through_a_graphed_call_raises():
    """The backward graph cannot be differentiated again: a backward
    with ``create_graph=True`` through a graphed call raises (shown on
    the pair's host double)."""
    toks = np.random.RandomState(10).randint(0, 512, (1, 8)) \
        .astype(np.float32)
    _, net = _twins(10, toks)
    net.hybridize()
    _host_pairs(net)
    x = torch.from_numpy(toks)
    params = list(net.parameters())
    for _ in range(2):                        # eager, then captured
        torch.autograd.grad(net(x).sum(), params)
    out = net(x).sum()
    with pytest.raises(MXNetError, match="create_graph=True"):
        torch.autograd.grad(out, params, create_graph=True)


def test_hybridize_aot_and_lint_raise_naming_their_slice(tmp_path):
    """``aot=`` is ported (S5c): the block arms and saves its call
    signatures; ``lint=True`` still raises, naming S9."""
    net = tllama.llama_small(device="cpu")
    path = str(tmp_path / "bundle.mxaot")
    assert net.hybridize(aot=path) is net
    assert net._active and net._aot_path == path
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, 512, (1, 8)).astype(np.float32))
    with torch.no_grad():
        net(toks)
    (entry,) = tcc.load_bundle(path)["entries"].values()
    assert entry["signature"]["args"][0]["shape"] == [1, 8]
    net.hybridize(False)
    with pytest.raises(MXNetError, match="S9"):
        net.hybridize(lint=True)
    assert not net._active
    net.hybridize(False, lint=True)           # disarming lints nothing


# -- the rules as plain functions -------------------------------------------

def test_signature_keys_shape_dtype_device_and_training():
    a = torch.zeros(2, 3)
    same = gc.signature((torch.ones(2, 3),), False)
    assert gc.signature((a,), False) == same
    assert gc.signature((a,), True) != same
    assert gc.signature((torch.zeros(3, 2),), False) != same
    assert gc.signature((a.double(),), False) != same
    assert gc.signature((a, 4), False) != gc.signature((a, 5), False)
    assert gc.signature((a, 4), False) == gc.signature((a, 4), False)


def test_storage_key_sees_a_move_and_not_an_in_place_update():
    p = torch.nn.Parameter(torch.zeros(4))
    key = gc.storage_key([p])
    with torch.no_grad():
        p.add_(1.0)
    assert gc.storage_key([p]) == key
    p.data = p.data.clone()
    assert gc.storage_key([p]) != key
    moved = gc.storage_key([p])
    p.data = p.data.to(torch.bfloat16)
    assert gc.storage_key([p]) != moved


def test_count_records_inside_a_capture_and_adds_outside():
    class Owner:
        n = 0

    gc.count(Owner, "n")
    assert Owner.n == 1
    with gc.recording() as rec:
        gc.count(Owner, "n", 3)
        gc.count(Owner, "n", 0)
        with gc.recording() as inner:
            gc.count(Owner, "n")
        assert inner == {(Owner, "n"): 1}
        gc.count(Owner, "n")
    assert rec == {(Owner, "n"): 4} and Owner.n == 1
    gc.count(Owner, "n", 2)
    assert Owner.n == 3


def test_captured_call_on_the_cpu_runs_every_call_eagerly():
    seen = []

    def fn(x, k):
        seen.append(k)
        return x * k

    cc = gc.CapturedCall(fn, "cpu", label="test")
    for k in (1, 2, 3):
        out = cc(torch.ones(2), k)
        assert torch.equal(out, torch.full((2,), float(k)))
    assert seen == [1, 2, 3]
    assert (cc.calls, cc.captures, cc.replays) == (3, 0, 0)
    assert not cc.graphed and not cc.static and cc.stream is None


def test_call_cache_gets_by_key_and_clears():
    cache = gc.CallCache()
    a = cache.get("a", lambda x: x + 1, "cpu", None, "a")
    assert cache.get("a", lambda x: x + 2, "cpu", None, "a") is a
    b = cache.get("b", lambda x: x * 3, "cpu", None, "b")
    assert b is not a and list(cache.calls) == ["a", "b"]
    assert torch.equal(a(torch.ones(2)), torch.full((2,), 2.0))
    assert cache.stats() == {"graphs": 0, "captures": 0, "replays": 0,
                             "backward_replays": 0, "busy_calls": 0,
                             "capture_s": 0.0, "host_s": 0.0,
                             "pool_bytes": 0}
    cache.clear()
    assert cache.calls == {}
    assert cache.get("a", lambda x: x, "cpu", None, "a") is not a


def test_watched_tensors_are_collected_again_only_after_a_tree_change():
    _, net = _twins(4, np.zeros((1, 4), np.float32))
    first = net._graph_tensors()
    assert net._graph_tensors() is first, "kept while the tree is unchanged"
    assert len(first) == len(list(net.parameters()))
    proj = net.blocks[0].attn.q_proj
    proj.weight.data = proj.weight.data.clone()   # same object, moved
    assert net._graph_tensors() is first
    new = torch.nn.Parameter(proj.weight.data.clone())
    proj.weight = new                              # a new object
    again = net._graph_tensors()
    assert again is not first and any(t is new for t in again)
    assert net._graph_tensors() is again
    net.float()                                    # a conversion
    assert net._graph_tensors() is not again
    kept = net._graph_tensors()
    net.clear_cache()
    assert net._graph_tensors() is not kept


# -- the serve runner ---------------------------------------------------------

SMALL = dict(num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             units=64, hidden_size=128, vocab_size=512, page_size=4,
             num_pages=32, max_pages_per_seq=8, max_batch=3,
             prefill_buckets=(8, 16), spec_k=2, prefill_chunk=4)
PROMPTS = [[3, 1, 4, 1, 5], [2], list(range(7, 27)), [9] * 11, [5, 6] * 3]


@pytest.fixture(scope="module")
def raw():
    mx.random.seed(3)
    net = jllama.llama_small()
    net.initialize()
    net(nd.array(np.zeros((1, 4), np.int32)))
    return jm.extract_weights(net)


def _counter_clock():
    c = itertools.count()
    return lambda: next(c) * 0.01


def _drive(srv, request_cls):
    reqs = [srv.scheduler.submit(request_cls(p, max_new_tokens=6))
            for p in PROMPTS]
    while srv.scheduler.has_work():
        srv._loop_tick()
    srv.scheduler.release_shared()
    srv.arena.assert_quiescent()
    return [r.result(timeout=0) for r in reqs]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_graphed_runner_on_a_cpu_arena_serves_the_jax_tokens(raw, kv_dtype):
    g = jm.KVGeometry(kv_dtype=kv_dtype, paged_kernel="auto", **SMALL)
    w = tuple([jax.device_put(np.asarray(raw[0]))]) + (
        [{k: jax.device_put(np.asarray(v)) for k, v in lw.items()}
         for lw in raw[1]], jax.device_put(np.asarray(raw[2])),
        None if raw[3] is None else jax.device_put(np.asarray(raw[3])))
    fns = {"decode": jax.jit(jm.build_decode_fn(w, g)),
           "verify": jax.jit(jm.build_verify_fn(w, g)),
           "chunk": jax.jit(jm.build_step_fn(w, g, g.prefill_chunk))}
    for b in g.prefill_buckets:
        fns["prefill_%d" % b] = jax.jit(jm.build_prefill_fn(w, g, b))
    jarena = jax_arena.PagedKVArena(g)
    want = _drive(jax_server.LlamaServer.from_parts(
        jax_server.AOTRunner(fns, jarena), jarena, clock=_counter_clock()),
        JaxRequest)

    gt = tm.KVGeometry(**g.to_dict())
    arena = ts.PagedKVArena(gt, device="cpu")
    runner = ts.TorchRunner(tm.convert_weights(raw, "float32", "cpu"), arena,
                            graphs=True)
    assert not runner.graphs, "a CPU arena runs eagerly"
    srv = ts.LlamaServer.from_parts(runner, arena, clock=_counter_clock())
    got = _drive(srv, ts.Request)
    assert got == want and all(len(t) == 6 for t in got)
    assert runner._graphs.calls == {}
    assert runner.graph_stats()["captures"] == 0
    assert srv.stats()["spec_proposed_tokens"] > 0, "verify ran on the path"


def test_prefill_takes_an_int_or_a_tensor_length(raw):
    g = tm.KVGeometry(**SMALL)
    w = tm.convert_weights(raw, "float32", "cpu")
    fn = tm.build_prefill_fn(w, g, 8)
    toks = torch.tensor([5, 6, 7, 8, 9, 0, 0, 0], dtype=torch.int32)
    row = torch.tensor([1, 2, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    outs = []
    for length in (5, torch.tensor(5, dtype=torch.int32)):
        arena = ts.PagedKVArena(g, device="cpu")
        with torch.no_grad():
            outs.append(fn(*arena.buffers(), toks, length, row)[-1])
    assert torch.equal(outs[0], outs[1])
    arena = ts.PagedKVArena(g, device="cpu")
    with torch.no_grad():
        full = tm.build_prefill_fn(w, g, 8)(*arena.buffers(), toks, 8,
                                            row)[-1]
    assert not torch.equal(full, outs[0]), "the length picks the row"


def test_a_capture_pauses_the_collector_and_restores_it():
    """Captures run with the cyclic collector paused (a collection there
    can free an earlier graph, which invalidates the capture on the
    card); the collector's state comes back as it was, nested or not."""
    import gc as collector

    assert collector.isenabled()
    with gc._collector_paused():
        assert not collector.isenabled()
        with gc._collector_paused():
            assert not collector.isenabled()
        assert not collector.isenabled()
    assert collector.isenabled()
    collector.disable()
    try:
        with gc._collector_paused():
            assert not collector.isenabled()
        assert not collector.isenabled()
    finally:
        collector.enable()
