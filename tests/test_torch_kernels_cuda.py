"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  CUDA kernels have no CPU mode, so every test here is marked
``cuda`` and skips where ``torch.cuda.is_available()`` is false.  The
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import optimizer_ops as oo
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops.paged_attention import _paged_ref, paged_attention


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels are CUDA "
                    "C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("page_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k1", [1, 5])
def test_kernel_matches_plain_on_card(card, k1, page_dtype):
    rng = np.random.default_rng(k1)
    b, h, kv, d, s_page, pages = 3, 32, 8, 128, 16, 40
    q = torch.from_numpy(rng.standard_normal((b, k1, h, d))
                         .astype(np.float32)).to(card)
    if page_dtype == "int8":
        kp, vp = (torch.from_numpy(rng.integers(
            -127, 128, size=(pages, s_page, kv, d)).astype(np.int8)).to(card)
            for _ in range(2))
        scales = tuple(torch.from_numpy(rng.uniform(
            0.01, 0.05, size=pages).astype(np.float32)).to(card)
            for _ in range(2))
    else:
        dt = getattr(torch, page_dtype)
        kp, vp = (torch.from_numpy(rng.standard_normal(
            (pages, s_page, kv, d)).astype(np.float32)).to(card, dt)
            for _ in range(2))
        scales = ()
    tbl = torch.tensor([[1, 2, 0, 3], [4, 5, 6, 7], [0, 0, 0, 0]],
                       dtype=torch.int32, device=card)
    pos = torch.tensor([40, 50, 0], dtype=torch.int32, device=card)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, tbl, pos, *scales)
    assert paged_attention.launches == before + 1
    want = _paged_ref(q, kp, vp, tbl, pos, *scales, scale=d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


_SPLIT_CASES = chip_smoke.split_cases()


def _split_args(card, case):
    label, b, k1, pages, maxp, pos, tbls, q_dt, p_dt = case
    rng = np.random.default_rng(len(label) + k1)
    return chip_smoke.make_case(rng, card, b, k1, 32, 8, 128, 16, pages,
                                maxp, q_dt, p_dt, pos, tbls)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SPLIT_CASES,
                         ids=["%s-%s-%s" % (c[0], str(c[7])[6:], str(c[8])[6:])
                              for c in _SPLIT_CASES])
def test_split_kernel_matches_plain_on_card(card, case):
    """K4 where the host splits a lane's context over blocks (contexts
    of 1..1,500 tokens, so some splits see nothing; a null page mid-table;
    an all-null lane; k1 = 5), and a chunk-sized k1 it does not split:
    held as the smoke holds it (``chip_smoke.paged_reading`` <= 1), with
    one combine launch exactly when n_split > 1."""
    args = _split_args(card, case)
    b, k1 = case[1], case[2]
    splits = pa.n_split(b, k1, 32, 8, 16, case[4], pa.sm_count(card.index))
    assert (splits > 1) == (k1 != 128)
    before = (paged_attention.launches, paged_attention.combine_launches)
    got = paged_attention(*args)
    assert (paged_attention.launches, paged_attention.combine_launches) \
        == (before[0] + 1, before[1] + (splits > 1))
    want = _paged_ref(*args, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert chip_smoke.paged_reading(got, want, case[7]) <= 1
    assert torch.equal(got, paged_attention(*args)), "two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1], ids=["f32-bf16", "bf16-bf16"])
def test_split_check_catches_a_dropped_split(card, index):
    """A combine built with MXTT_DROP_SPLIT=1 (split 1 left out) must
    fail the check the split cases pass, with f32 queries and with the
    serve path's bf16 queries (an absolute tolerance)."""
    from mxnet_tpu_torch.ops import _build

    case = _SPLIT_CASES[index]
    assert case[0] == "ctx 1..1500" and case[8] == torch.bfloat16
    args = _split_args(card, case)
    want = _paged_ref(*args, scale=128 ** -0.5)
    path = _build.build(pa._SOURCE, defines=("MXTT_DROP_SPLIT=1",))
    reading = chip_smoke.planted_split_fault(pa, path, (args, want, case[7]))
    assert reading > 1


# -- flash attention (K1, K2, K3) -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("t_q,t_kv,d,causal", [
    (128, 128, 64, True), (100, 100, 128, True), (100, 100, 64, False),
    (64, 200, 32, True), (200, 64, 16, True), (64, 200, 64, True),
    (200, 70, 128, True), (7, 7, 8, False),
    (257, 257, 256, True)])
@pytest.mark.parametrize("dtype,misalign", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True)])
def test_flash_kernels_match_plain_on_card(card, t_q, t_kv, d, causal, dtype,
                                           misalign):
    """K1 (out, lse), K2 (dq) and K3 (dk, dv) against the plain versions
    on the same inputs; bf16 at head dims 64 and 128 on the tensor-core
    kernels, and (with buffers off 16-byte alignment) on the CUDA-core
    kernels.  f32 and lse: atol/rtol 2e-4 (sums in another order); bf16
    outputs: ``chip_smoke.tile_reading``, per head and tile of 64 rows."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(t_q * 1000 + d)
    q, k, v, do = chip_smoke.flash_case(rng, card, 3, t_q, t_kv, d, dt,
                                         misalign)
    scale = d ** -0.5
    out, lse = fa._fwd_kernel(q, k, v, scale, causal)
    out_r, lse_r = fa._flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * out.float()).sum(-1)
    got = fa._bwd_kernels(q, k, v, do, lse, delta, scale, causal)
    want = fa._flash_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_r, rtol=2e-4, atol=2e-4)
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out,) + got,
                          (out_r,) + want):
        assert g.dtype == dt, name
        if dt == torch.float32:
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4,
                                       msg=lambda m: "%s: %s" % (name, m))
        else:
            assert max(chip_smoke.tile_reading(g, w)) <= 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t_q,t_kv,d,causal", chip_smoke.edge_shapes())
def test_flash_wgmma_tile_edges_match_plain_on_card(card, bh, t_q, t_kv, d,
                                                    causal):
    """bf16 at the wgmma kernels' tile edges (K1: 128 query rows a block,
    128 keys a step; K3: 128 keys a block, 64 queries a step), held as the
    smoke holds them (``chip_smoke.flash_compare``: each reading <= 1)."""
    rng = np.random.default_rng(t_q * 1000 + t_kv + d)
    args = chip_smoke.flash_case(rng, card, bh, t_q, t_kv, d, torch.bfloat16)
    res = chip_smoke.flash_compare(fa, args, d ** -0.5, causal)[0]
    for name, (reading, _) in res.items():
        assert reading <= 1, (name, reading)


@pytest.mark.cuda
def test_flash_wgmma_kernels_have_hgmma(card):
    """K1, K2 and K3 at head dims 64 and 128 have HGMMA (wgmma) in their
    SASS, and no HMMA (mma.sync) is left anywhere in the library."""
    counts = chip_smoke.hgmma_counts(fa.build())
    for stem in chip_smoke.WGMMA_KERNELS.values():
        for hd in (64, 128):
            kind = "%sILi%dE" % (stem, hd)
            assert any(kind in fn and n > 0 for fn, n in counts.items()), \
                kind
    assert not any(chip_smoke.sass_counts(fa.build(), "HMMA").values())


@pytest.mark.cuda
def test_flash_dq_with_misaligned_rows_takes_cuda_cores(card):
    """lse and delta 4 bytes off alignment send K2 to the CUDA-core
    kernel, which must agree with the plain version too."""
    chip_smoke.misaligned_rows_check(fa, card, np.random.default_rng(9))


@pytest.mark.cuda
def test_flash_counts_launches_and_backward_is_bitwise_repeatable(card):
    rng = np.random.default_rng(5)
    q, k, v, do = (t.reshape(2, 4, 200, 128) for t in chip_smoke.flash_case(
        rng, card, 8, 200, 200, 128, torch.bfloat16))
    counts = (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    grads = []
    for _ in range(2):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fa.flash_attention(qq, kk, vv, causal=True)
        out.backward(do)
        grads.append([t.grad for t in (qq, kk, vv)])
    torch.cuda.synchronize()
    assert (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches) == tuple(c + 2 for c in counts)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# -- mx.rtc (K5): user CUDA C++ compiled by NVRTC ---------------------------

def _rtc():
    import mxnet_tpu_torch as mx
    return mx


@pytest.mark.cuda
def test_rtc_scale_add_is_exact(card):
    mx = _rtc()
    ctx = mx.gpu(0)
    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal((8, 128)).astype(np.float32)
            for _ in range(2))
    k = mx.rtc.CudaModule(chip_smoke.SCALE_ADD_SOURCE).get_kernel(
        "scale_add", chip_smoke.SCALE_ADD_SIGNATURE)
    out = mx.nd.empty((8, 128), ctx=ctx)
    k.launch([mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx), out,
              x.size], ctx, (4, 1, 1), (256, 1, 1))
    assert k.launches == 1
    np.testing.assert_array_equal(out.asnumpy(), x * 2 + y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,offset", [(4096 * 96, 0), (1000003, 0),
                                      (4096 * 96, 1)])
def test_rtc_swiglu_kernels_match_plain(card, dtype, n, offset):
    """Forward and backward against the plain versions (f32 arithmetic,
    rounded once): within 1 ulp in bf16, 2e-6 relative in f32; a ragged
    tail and buffers off 16-byte alignment take the scalar path."""
    mx = _rtc()
    ctx, dt = mx.gpu(0), getattr(torch, dtype)
    gen = torch.Generator(device=card)
    gen.manual_seed(n + offset)
    a, b, dh = (torch.randn(n + offset, generator=gen, device=card)
                .mul_(s).to(dt)[offset:] for s in (2.0, 1.0, 0.05))
    A, B, DH = (mx.nd.NDArray(t, ctx=ctx) for t in (a, b, dh))
    kern = chip_smoke.SwigluKernels(mx)
    h = kern.fwd(A, B)
    da, db = kern.bwd(A, B, DH)
    want = (chip_smoke.swiglu_fwd_ref(a, b),) + \
        chip_smoke.swiglu_bwd_ref(a, b, dh)
    torch.cuda.synchronize()
    for got, w in zip((h, da, db), want):
        if dt == torch.bfloat16:
            assert chip_smoke.bf16_ulps(got.data(), w).max().item() <= 1
        else:
            torch.testing.assert_close(got.data(), w, rtol=2e-6, atol=1e-7)


_TEMPLATE_SOURCE = r"""
template <typename T, int K>
__global__ void add_k(T *x, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] += T(K);
}
"""


@pytest.mark.cuda
def test_rtc_exports_resolve_mangled_template_names(card):
    mx = _rtc()
    ctx = mx.gpu(0)
    mod = mx.rtc.CudaModule(_TEMPLATE_SOURCE,
                            exports=("add_k<float, 3>", "add_k<int, 5>"))
    kf = mod.get_kernel("add_k<float, 3>", "float *x, long long n")
    ki = mod.get_kernel("add_k<int, 5>", "int *x, long long n")
    assert kf.lowered.startswith("_Z") and kf.lowered != ki.lowered
    xf = mx.nd.zeros((1000,), ctx=ctx)
    xi = mx.nd.zeros((1000,), ctx=ctx, dtype="int32")
    kf.launch([xf, 1000], ctx, (4,), (256,))
    ki.launch([xi, 1000], ctx, (4,), (256,))
    kf.launch([xf, 1000], ctx, (4,), (256,))
    np.testing.assert_array_equal(xf.asnumpy(), 6.0)
    np.testing.assert_array_equal(xi.asnumpy(), 5)
    with pytest.raises(mx.MXNetError, match="needs torch.int32"):
        ki.launch([xf, 1000], ctx, (4,), (256,))


_SMEM_SOURCE = r"""
extern "C" __global__ void reverse_block(const float *x, float *y, int n) {
  extern __shared__ float buf[];
  const float *src = x + (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = src[i];
  __syncthreads();
  float *dst = y + (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = buf[n - 1 - i];
}
"""


@pytest.mark.cuda
def test_rtc_dynamic_shared_memory_over_48k(card):
    """Each block reverses a 24,576-float row through 96 KB of dynamic
    shared memory: the launch must raise the kernel's limit first."""
    mx = _rtc()
    ctx, n, rows = mx.gpu(0), 24576, 6
    k = mx.rtc.CudaModule(_SMEM_SOURCE).get_kernel(
        "reverse_block", "const float *x, float *y, int n")
    x = np.arange(rows * n, dtype=np.float32).reshape(rows, n)
    y = mx.nd.empty((rows, n), ctx=ctx)
    k.launch([mx.nd.array(x, ctx=ctx), y, n], ctx, (rows,), (512,),
             shared_mem=4 * n)
    np.testing.assert_array_equal(y.asnumpy(), x[:, ::-1])


@pytest.mark.cuda
def test_rtc_compile_error_and_bad_launch_raise(card):
    mx = _rtc()
    ctx = mx.gpu(0)
    with pytest.raises(mx.MXNetError, match="mxtt_undeclared") as ei:
        mx.rtc.CudaModule('extern "C" __global__ void k(float *x) '
                          '{ x[0] = mxtt_undeclared; }')
    assert "error" in str(ei.value)
    k = mx.rtc.CudaModule(chip_smoke.SCALE_ADD_SOURCE).get_kernel(
        "scale_add", chip_smoke.SCALE_ADD_SIGNATURE)
    x = mx.nd.ones((64,), ctx=ctx)
    out = mx.nd.zeros((64,), ctx=ctx)
    # 4096 threads a block is more than the card takes: cuLaunchKernel
    # refuses it, names the error, and the write var is poisoned
    with pytest.raises(mx.MXNetError, match="cuLaunchKernel failed"):
        k.launch([x, x, out, 64], ctx, (1,), (4096,))
    assert k.launches == 0
    with pytest.raises(mx.MXNetError, match="cuLaunchKernel failed"):
        out.wait_to_read()
    k.launch([x, x, out, 64], ctx, (1,), (64,))
    np.testing.assert_array_equal(out.asnumpy(), 3.0)


_SLOW_SOURCE = r"""
extern "C" __global__ void slow_fill(float *y, int n, long long cycles) {
  long long t0 = clock64();
  while (clock64() - t0 < cycles) { }
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = 7.0f;
}
"""


@pytest.mark.cuda
def test_rtc_write_is_ordered_before_a_torch_read_on_its_stream(card):
    """A slow RTC write, then a torch reduction of its output, on a side
    stream: the host returns before either runs (no sync per launch), and
    the reduction sees the kernel's values."""
    mx = _rtc()
    ctx, n = mx.gpu(0), 1 << 16
    k = mx.rtc.CudaModule(_SLOW_SOURCE).get_kernel(
        "slow_fill", "float *y, int n, long long cycles")
    y = mx.nd.zeros((n,), ctx=ctx)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        # load both kernels first: a module's first (lazy) load may wait
        # for the work in flight
        k.launch([y, n, 0], ctx, (n // 256,), (256,))
        y.data().sum()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        k.launch([y, n, 200_000_000], ctx, (n // 256,), (256,))
        total = y.data().sum()
        done = torch.cuda.Event()
        done.record()
    assert not done.query(), "the launch waited for the kernel"
    y.wait_to_read()          # waits on the side stream the write went to
    assert done.query()
    assert total.item() == 7.0 * n


# -- captured CUDA graphs: the serve steps and hybridize() ----------------

def _graph_geometry(kind):
    from mxnet_tpu_torch import serve as ts

    dtype = "bfloat16" if kind == "bf16" else "float32"
    return ts.KVGeometry(num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, units=64, hidden_size=128,
                         vocab_size=512, page_size=4, num_pages=32,
                         max_pages_per_seq=8, max_batch=3,
                         prefill_buckets=(8, 16), spec_k=2, prefill_chunk=4,
                         dtype=dtype,
                         kv_dtype="int8" if kind == "int8" else None)


_LANE_A = np.array([1, 2, 3, 9, 0, 0, 0, 0], np.int32)
_LANE_B = np.array([4, 5, 6, 7, 8, 0, 0, 0], np.int32)
_TABLES = np.stack([_LANE_A, _LANE_B, np.zeros(8, np.int32)])


def _step_script(seed):
    """Prefill of two lanes (both buckets), then decode, verify and chunk
    over them with a third lane inactive on the null page."""
    rng = np.random.default_rng(seed)
    tok = lambda *s: rng.integers(1, 512, size=s).astype(np.int32)  # noqa
    three = lambda a: np.concatenate([a, np.zeros_like(a[:1])])  # noqa
    yield "prefill", (8, tok(5), 5, _LANE_A)
    yield "prefill", (16, tok(11), 11, _LANE_B)
    yield "decode", (three(tok(2)), np.array([5, 11, 0], np.int32), _TABLES)
    yield "verify", (three(tok(2, 3)), np.array([6, 12, 0], np.int32),
                     _TABLES)
    yield "chunk", (three(tok(2, 4)), np.array([9, 15, 0], np.int32),
                    _TABLES)


def _run_script(runner, seed):
    return [getattr(runner, name)(*args) for name, args in
            _step_script(seed)]


def _runner_pair(card, kind, n_graphed=1):
    from mxnet_tpu_torch import serve as ts

    g = _graph_geometry(kind)
    w = ts.init_weights(g, seed=5, std=0.5, device=card)
    eager = ts.TorchRunner(w, ts.PagedKVArena(g, device=card), graphs=False)
    graphed = [ts.TorchRunner(w, ts.PagedKVArena(g, device=card))
               for _ in range(n_graphed)]
    return eager, graphed


def _assert_same(graphed, eager, got, want, what):
    for name, (a, b) in zip(("prefill 8", "prefill 16", "decode", "verify",
                             "chunk"), zip(got, want)):
        assert np.array_equal(a, b), "%s: %s logits" % (what, name)
    for a, b in zip(graphed.arena.buffers(), eager.arena.buffers()):
        # page 0 is the null page: pad and inactive-lane rows race there
        assert torch.equal(a[:, 1:], b[:, 1:]), what + ": arena bytes"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_graphed_serve_steps_equal_eager_on_card(card, kind):
    """Each step signature runs eagerly, then is captured and replayed:
    logits and arena bytes stay bitwise equal to ``graphs=False`` after
    every call, and K4's count grows by one launch per layer per
    replayed step."""
    eager, (graphed,) = _runner_pair(card, kind)
    assert graphed.graphs and not eager.graphs
    for rnd in range(3):
        want = _run_script(eager, rnd)
        before = pa.paged_attention.launches
        got = _run_script(graphed, rnd)
        _assert_same(graphed, eager, got, want, "round %d" % rnd)
        if rnd == 2:     # decode, verify and chunk all replayed
            assert pa.paged_attention.launches - before == 3 * 2
    stats = graphed.graph_stats()
    assert stats["graphs"] == stats["captures"] == 5
    assert stats["replays"] == 10 and stats["pool_bytes"] > 0
    assert all(cc.calls == 3 for cc in graphed._graphs.calls.values())


@pytest.mark.cuda
def test_serve_graph_recaptures_when_the_arena_moves_on_card(card):
    eager, (graphed,) = _runner_pair(card, "f32")
    for rnd in range(2):
        _run_script(eager, rnd)
        _run_script(graphed, rnd)
    arena = graphed.arena
    arena.kv_k = arena.kv_k.clone()       # as a step returning fresh state
    want = _run_script(eager, 2)
    got = _run_script(graphed, 2)
    _assert_same(graphed, eager, got, want, "after the move")
    assert all(cc.captures == 2 for cc in graphed._graphs.calls.values())


@pytest.mark.cuda
def test_two_runners_capture_at_once_on_two_threads(card):
    """Two serve loops of one process capture on their own streams at
    about the same time; neither breaks the other's capture."""
    import threading

    eager, graphed = _runner_pair(card, "bf16", n_graphed=2)
    want = [_run_script(eager, rnd) for rnd in range(3)]
    results, errors = {}, []
    gate = threading.Barrier(2)

    def loop(i):
        try:
            out = []
            for rnd in range(3):
                gate.wait(timeout=60)
                out.append(_run_script(graphed[i], rnd))
            torch.cuda.current_stream().synchronize()
            results[i] = out
        except Exception as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(2):
        for rnd in range(3):
            for a, b in zip(results[i][rnd], want[rnd]):
                assert np.array_equal(a, b), "runner %d round %d" % (i, rnd)
        assert graphed[i].graph_stats()["captures"] == 5


def _hybrid_net(card):
    from mxnet_tpu_torch import init
    from mxnet_tpu_torch.gluon.model_zoo import llama as tllama

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(0)
    net = tllama.llama_small(device=card)
    net.initialize(init.Xavier(), generator=gen)
    return net


def _eager(net, x):
    """The net's eager output: a nested call runs its blocks eagerly
    (a recorded call would replay a graph pair)."""
    with torch.no_grad():
        return net._nested_call(x)


@pytest.mark.cuda
def test_hybridized_block_equals_eager_and_recaptures_on_card(card):
    net = _hybrid_net(card)
    x = torch.randint(0, 512, (2, 16), device=card)
    net.hybridize()
    with torch.no_grad():
        outs = [net(x) for _ in range(3)]
    want = _eager(net, x)
    for out in outs:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    (cc,) = net._graphs.calls.values()
    assert (cc.calls, cc.captures, cc.replays) == (3, 1, 2)
    assert outs[1].data_ptr() != outs[2].data_ptr(), "fresh outputs"
    # an in-place update shows in the next replay
    with torch.no_grad():
        net.norm.weight.mul_(1.5)
        got = net(x)
    torch.testing.assert_close(got, _eager(net, x), rtol=1e-5, atol=1e-6)
    assert cc.captures == 1
    # a parameter whose storage moved is captured again
    net.norm.weight.data = net.norm.weight.data.clone() * 0.5
    with torch.no_grad():
        got = net(x)
    torch.testing.assert_close(got, _eager(net, x), rtol=1e-5, atol=1e-6)
    assert cc.captures == 2
    # so is a parameter replaced by a new object
    net.norm.weight = torch.nn.Parameter(net.norm.weight.data * 2.0)
    with torch.no_grad():
        got = net(x)
    torch.testing.assert_close(got, _eager(net, x), rtol=1e-5, atol=1e-6)
    assert cc.captures == 3
    # a new input shape is a new signature
    y = torch.randint(0, 512, (1, 24), device=card)
    with torch.no_grad():
        got = [net(y) for _ in range(2)]
    assert len(net._graphs.calls) == 2
    for out in got:
        torch.testing.assert_close(out, _eager(net, y), rtol=1e-5, atol=1e-6)
    # cast drops the graphs; the bf16 graph equals the bf16 eager call
    net.cast("bfloat16")
    assert not net._graphs.calls
    with torch.no_grad():
        got = [net(x) for _ in range(3)]
    want = _eager(net, x)
    for out in got:
        assert torch.equal(out, want)
    net.hybridize(False)
    assert not net._graphs.calls


@pytest.mark.cuda
def test_k1_count_grows_with_replays_on_card(card):
    net = _hybrid_net(card)
    x = torch.randint(0, 512, (1, 32), device=card)
    net.hybridize()
    with torch.no_grad():
        net(x)
        net(x)                               # captured and replayed
        before = fa.flash_attention.fwd_launches
        for _ in range(3):
            net(x)
    assert fa.flash_attention.fwd_launches - before == 3 * 2


@pytest.mark.cuda
def test_a_failed_capture_raises_and_the_process_goes_on_on_card(card):
    """A host read inside the function invalidates its capture: the call
    raises MXNetError, and afterwards random draws outside a graph, a
    capture that draws random numbers and its replays all work."""
    from mxnet_tpu_torch import graph_cache as gc
    from mxnet_tpu_torch.base import MXNetError

    x = torch.ones(8, device=card)
    bad = gc.CapturedCall(lambda a: a * float(a.sum().item()), card,
                          label="host read")
    assert torch.equal(bad(x), torch.full((8,), 8.0, device=card))
    for _ in range(2):
        with pytest.raises(MXNetError, match="capture of host read failed"):
            bad(x)
    assert bad.captures == 0 and bad.graphs == ()
    r = torch.randint(0, 10, (4096,), device=card)
    assert 0 <= int(r.min()) and int(r.max()) < 10
    good = gc.CapturedCall(lambda a: (a * 2, torch.rand(64, device=a.device)),
                           card, label="good")
    outs = [tuple(t.clone() for t in good(x)) for _ in range(3)]
    assert (good.captures, good.replays) == (1, 2)
    for doubled, drawn in outs:
        assert torch.equal(doubled, torch.full((8,), 2.0, device=card))
        assert bool(((drawn >= 0) & (drawn < 1)).all())
    assert not torch.equal(outs[1][1], outs[2][1]), "each replay draws anew"
    torch.cuda.synchronize()


# -- S5b: recorded calls, the train step graph, bulked segments ------------

def _grads(net, x, call=None):
    """Gradients of a mean-square head over ``net``'s output, through
    ``call`` (default the net itself)."""
    out = (call or net)(x)
    loss = (out.float() ** 2).mean()
    return torch.autograd.grad(loss, list(net.parameters()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recorded_hybridized_grads_bitwise_equal_eager_on_card(card, dtype):
    net = _hybrid_net(card)
    if dtype == "bfloat16":
        net.cast("bfloat16")
    x = torch.randint(0, 512, (2, 16), device=card)
    with torch.enable_grad():
        want = _grads(net, x, net._nested_call)
        net.hybridize()
        got = [_grads(net, x) for _ in range(3)]
    (pair,) = net._graphs.calls.values()
    assert (pair.calls, pair.captures, pair.replays,
            pair.backward_replays) == (3, 1, 2, 2)
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))


@pytest.mark.cuda
def test_busy_pair_runs_eagerly_with_eager_grads_on_card(card):
    net = _hybrid_net(card)
    xs = [torch.randint(0, 512, (1, 16), device=card) for _ in range(2)]

    def two(call):
        loss = sum((call(x).float() ** 2).mean() for x in xs)
        return torch.autograd.grad(loss, list(net.parameters()))

    want = two(net._nested_call)
    net.hybridize()
    for _ in range(2):
        _grads(net, xs[0])                    # eager, then captured
    got = two(net)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st = net.stats()
    assert st["busy_calls"] == 1 and st["captures"] == 1


@pytest.mark.cuda
def test_other_graphs_between_a_pairs_forward_and_backward_on_card(card):
    """Each graph pair captures into a pool of its own.  Two pairs whose
    backwards run in another order than they were captured (forward B,
    forward A, backward A, backward B), and an unrecorded call captured
    before the pair and replayed between its forward and its backward,
    leave the gradients bitwise equal to eager."""
    net = _hybrid_net(card)
    params = list(net.parameters())
    xa = torch.randint(0, 512, (1, 16), device=card)
    xb = torch.randint(0, 512, (2, 32), device=card)

    def head(out):
        return (out.float() ** 2).mean()

    def interleaved(call):
        lb, la = head(call(xb)), head(call(xa))
        return (torch.autograd.grad(la, params)
                + torch.autograd.grad(lb, params))

    def between(call):
        loss = head(call(xa))
        with torch.no_grad():
            call(xb)
        return torch.autograd.grad(loss, params)

    with torch.enable_grad():
        want = interleaved(net._nested_call), between(net._nested_call)
        net.hybridize()
        with torch.no_grad():
            for _ in range(2):
                net(xb)                       # eager, then captured
        for x in (xa, xb):
            for _ in range(2):
                _grads(net, x)                # each pair: eager, captured
        for _ in range(2):
            got = interleaved(net), between(net)
            for g, w in zip(got, want):
                assert all(torch.equal(a, b) for a, b in zip(g, w))
    st = net.stats()
    assert (st["captures"], st["busy_calls"]) == (3, 0)
    pools = {cc.held_pool for cc in net._graphs.calls.values()}
    assert len(pools) == 3, "each pair holds a pool of its own"


@pytest.mark.cuda
def test_k2_k3_counts_grow_with_backward_replays_on_card(card):
    net = _hybrid_net(card)
    layers = len(net.blocks)
    x = torch.randint(0, 512, (1, 32), device=card)
    net.hybridize()
    for _ in range(2):
        _grads(net, x)                        # eager, then captured
    before = [getattr(fa.flash_attention, n)
              for n in ("fwd_launches", "dq_launches", "dkv_launches")]
    for _ in range(3):
        _grads(net, x)
    after = [getattr(fa.flash_attention, n)
             for n in ("fwd_launches", "dq_launches", "dkv_launches")]
    assert [a - b for a, b in zip(after, before)] == [3 * layers] * 3


def _train_step(card, graphs, clip=None):
    from mxnet_tpu_torch import gluon, parallel

    net = _hybrid_net(card)
    return net, parallel.JitTrainStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adamw",
        {"learning_rate": 1e-3, "wd": 0.01}, graphs=graphs,
        clip_global_norm=clip)


@pytest.mark.cuda
def test_graphed_train_step_bitwise_equal_eager_on_card(card):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 512, (2, 16)).astype(np.int32)
    y = rng.integers(0, 512, (2, 16)).astype(np.float32)
    runs = []
    for graphs in (False, True):
        net, step = _train_step(card, graphs)
        losses = []
        for i in range(5):
            if i == 3:
                step._opt.set_learning_rate(3e-3)
            losses.append(step.step(x, y).clone())
        losses.append(step.step_n(4, x, y).clone())
        runs.append((net, losses, step))
    (e_net, e_loss, _), (g_net, g_loss, g_step) = runs
    assert all(torch.equal(a, b) for a, b in zip(e_loss, g_loss))
    for (name, a), b in zip(e_net.named_parameters(), g_net.parameters()):
        assert torch.equal(a, b), name
    st = g_step.stats()
    assert (st["captures"], st["replays"]) == (1, 8)


@pytest.mark.cuda
def test_bulked_segments_bitwise_equal_eager_on_two_threads_on_card(card):
    import threading

    import mxnet_tpu_torch as mx

    def work(seed, out):
        rng = np.random.default_rng(seed)
        ctx = mx.gpu(0)
        w = mx.nd.array(rng.standard_normal((64, 64)).astype(np.float32),
                        ctx=ctx)
        x = mx.nd.array(rng.standard_normal((32, 64)).astype(np.float32),
                        ctx=ctx)
        w.attach_grad()
        res = []
        for _ in range(4):
            with mx.autograd.record():
                h = mx.nd.tanh(mx.nd.dot(x, w)) * 1.5 + 0.25
                loss = (h * h).mean()
            loss.backward()
            z = (w * 2.0 + 1.0).sum(axis=0)
            res.append((loss.asnumpy(), w.grad.asnumpy(), z.asnumpy()))
        out[seed] = (res, mx.engine.Engine.get().segment_stats())

    eager = {}
    with mx.engine.bulk(0):
        for seed in (1, 2):
            work(seed, eager)
    bulked = {}
    threads = [threading.Thread(target=work, args=(s, bulked))
               for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for seed in (1, 2):
        got, st = bulked[seed]
        want, _ = eager[seed]
        for a, b in zip(got, want):
            assert all(np.array_equal(p, q) for p, q in zip(a, b))
        assert st["graphs"]["replays"] > 0, "segments replayed on the card"


@pytest.mark.cuda
def test_two_thread_gradients_equal_eager_in_forty_repeats_on_card(card):
    """F19: the two-thread check above, 40 times eager (``bulk(0)`` in
    each thread) and 40 times bulked.  Before the repair one thread's
    backward cleared the other's leaf gradient now and then, and its
    ``w.grad`` kept the zeros of ``attach_grad`` at the first step (the
    probe, ``tools/torch_f19_probe.py``, saw it in 2 of 30 eager and 2
    to 4 of 30 bulked repeats)."""
    import contextlib
    import threading

    import mxnet_tpu_torch as mx

    def work(seed, out, size):
        rng = np.random.default_rng(seed)
        ctx = mx.gpu(0)
        with mx.engine.bulk(0) if size == 0 else contextlib.nullcontext():
            w = mx.nd.array(rng.standard_normal((64, 64))
                            .astype(np.float32), ctx=ctx)
            x = mx.nd.array(rng.standard_normal((32, 64))
                            .astype(np.float32), ctx=ctx)
            w.attach_grad()
            res = []
            for _ in range(4):
                with mx.autograd.record():
                    h = mx.nd.tanh(mx.nd.dot(x, w)) * 1.5 + 0.25
                    loss = (h * h).mean()
                loss.backward()
                res.append((loss.asnumpy(), w.grad.asnumpy()))
        out[seed] = res

    want = {}
    for seed in (1, 2):
        work(seed, want, 0)
    failed = []
    for rep in range(40):
        for size in (0, None):
            got = {}
            threads = [threading.Thread(target=work, args=(s, got, size))
                       for s in (1, 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
                assert not t.is_alive()
            for seed in (1, 2):
                for step, (a, b) in enumerate(zip(got[seed], want[seed])):
                    if not all(np.array_equal(p, q) for p, q in zip(a, b)):
                        failed.append((rep, size, seed, step))
    assert failed == [], failed


# -- S6a: ResNet's graphs, with BatchNorm writing its running statistics ---
# (chip_smoke's checks at a small size: f32, TF32 off, deterministic
# cuDNN; each raises where the graphed path differs from eager by a bit)

@pytest.mark.cuda
def test_a_collection_inside_a_capture_frees_no_graph_on_card(card):
    """A CUDA graph that only the collector can free (a reference cycle,
    as an earlier step's graphs are) must not be freed inside another
    capture: torch's ``CUDAGraph.reset()`` there invalidates the capture
    (``cudaErrorStreamCaptureInvalidated``; ROADMAP §3).  With the
    collector's threshold at 1 any allocation would collect; the capture
    keeps it paused."""
    import gc

    from mxnet_tpu_torch import graph_cache

    old = torch.cuda.CUDAGraph()
    x = torch.ones(4096, device=card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        old.capture_begin(pool=torch.cuda.graph_pool_handle())
        kept = x * 5
        old.capture_end()
    torch.cuda.synchronize()
    box = [old, kept]
    box.append(box)
    holder = [box]
    del box, old, kept
    thresholds = gc.get_threshold()

    def fn():
        y = x * 2
        holder.clear()          # now only the collector can free the graph
        junk = [[i] for i in range(200)]     # the collector's trigger
        del junk
        return y + 1

    graph = torch.cuda.CUDAGraph()
    gc.set_threshold(1)
    try:
        with graph_cache._capture_lock:
            out, _ = graph_cache._capture_into(
                graph, torch.cuda.graph_pool_handle(), side, "probe", fn)
    finally:
        gc.set_threshold(*thresholds)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(x, 3.0))
    assert gc.isenabled()
    gc.collect()                               # freed here, after it


@pytest.mark.cuda
def test_backward_overwrites_gradients_through_the_pair_on_card(card):
    """The JAX package's ``grad_req="write"`` through a hybridized block
    under ``record()``: each ``backward()`` through the graph pair (the
    eager first call, the capture, then replays) leaves the eager
    block's gradients of one backward, bitwise, where torch would add
    them up."""
    from mxnet_tpu_torch import autograd

    eager, net = _hybrid_net(card), _hybrid_net(card)
    x = torch.randint(0, 512, (2, 16), device=card)

    def backward(block):
        with autograd.record():
            loss = (block(x).float() ** 2).mean()
        loss.backward()
        return [p.grad.clone() for p in block.parameters()]

    want = backward(eager)
    assert all(torch.equal(a, b) for a, b in zip(backward(eager), want))
    net.hybridize()
    for _ in range(4):
        got = backward(net)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    (pair,) = net._graphs.calls.values()
    assert (pair.captures, pair.replays, pair.backward_replays) == (1, 3, 3)


def _raw_tensor_runs(device, hybrid):
    """A tensor that no block owns, trained by a ``gluon.Trainer`` in
    two eager steps, then made a block's parameter and trained by the
    same Trainer in three ``record()`` steps (through the graph pair when
    ``hybrid``) and by a ``JitTrainStep`` (graphed when ``hybrid``) in
    three: the gradients after each Trainer step, the step's losses, the
    weight and the graph counts."""
    from mxnet_tpu_torch import autograd, gluon, parallel

    class RawWeight(gluon.HybridBlock):
        def __init__(self, w):
            super().__init__()
            self.w = w

        def forward(self, x):
            return torch.tanh(x @ self.w)

    rng = np.random.default_rng(5)
    w = torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal((16, 16)).astype(np.float32)).to(device))
    x = torch.from_numpy(
        rng.standard_normal((8, 16)).astype(np.float32)).to(device)
    trainer = gluon.Trainer([w], "sgd", {"learning_rate": 0.1})
    grads = []
    for _ in range(2):
        (torch.tanh(x @ w) ** 2).mean().backward()
        trainer.step(1)
        grads.append(w.grad.clone())
    net = RawWeight(w)
    if hybrid:
        net.hybridize()
    for _ in range(3):
        with autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
        trainer.step(1)
        grads.append(w.grad.clone())
    del loss
    stats = net.stats() if hybrid else None
    net.hybridize(False)
    # no loss block: the step's loss is the mean of the net's output
    step = parallel.JitTrainStep(net, None, "sgd", {"learning_rate": 0.1},
                                 graphs=hybrid)
    losses = [step.step(x).clone() for _ in range(3)]
    return grads, losses, w.detach().clone(), stats, step.stats()


@pytest.mark.cuda
def test_trainer_raw_tensor_then_captures_on_card(card):
    """A Trainer's raw tensor, trained eagerly and then captured in a
    graph pair and a graphed ``JitTrainStep``: the Trainer holds no
    autograd node of its eager steps (one made on the caller's stream
    and held into a capture on another makes the capture fail), and the
    graphed runs are bitwise equal to eager."""
    torch.backends.cuda.matmul.allow_tf32 = False
    want = _raw_tensor_runs(card, False)
    got = _raw_tensor_runs(card, True)
    for a, b in zip(got[:3], want[:3]):
        a, b = (a, b) if isinstance(a, list) else ([a], [b])
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert (got[3]["captures"], got[3]["backward_replays"]) == (1, 2)
    assert got[4]["captures"] == 1


@pytest.mark.cuda
def test_flash_kernels_match_plain_at_bert_shape_on_card(card):
    """K1, K2 and K3 at BERT-base's train shape (B*H 384, T 128, D 64,
    non-causal, bf16: one 128-row tile a head, on the wgmma kernels)
    against their plain versions, each reading <= 1
    (``chip_smoke.flash_compare``)."""
    b, h, t, d = (chip_smoke.BERT_FLASH[k] for k in "bhtd")
    args = chip_smoke.flash_case(np.random.default_rng(11), card, b * h, t,
                                 t, d, torch.bfloat16)
    res = chip_smoke.flash_compare(fa, args, d ** -0.5, False)[0]
    for name, (reading, _) in res.items():
        assert reading <= 1, name


@pytest.mark.cuda
def test_bert_graphed_train_step_bitwise_equal_eager_on_card(card):
    """bert_small's JitTrainStep (adam, an lr change, step_n) over the
    MLM wrapper: losses and weights bitwise equal to eager."""
    chip_smoke.bert_train_step_check(card)


@pytest.mark.cuda
def test_bert_hybridized_forward_and_pair_bitwise_equal_eager_on_card(card):
    """bert_small hybridized: the forward, Trainer steps under record()
    through the graph pair and two more backward passes (one pass's
    gradients) bitwise equal to eager."""
    chip_smoke.bert_hybrid_checks(card)


@pytest.mark.cuda
def test_resnet_graphed_train_step_bitwise_equal_eager_on_card(card):
    """JitTrainStep (sgd momentum, an lr change, step_n) on resnet18_v1:
    losses, weights and running statistics bitwise equal to eager."""
    chip_smoke.resnet_train_step_check(card, "resnet18_v1", 4, 32)


@pytest.mark.cuda
def test_resnet_hybridized_forward_bitwise_equal_eager_on_card(card):
    """Predict- and train-mode hybridized forwards: outputs and running
    statistics bitwise equal to eager, one capture a mode."""
    chip_smoke.resnet_hybrid_forward_check(card, "resnet18_v1", 4, 32)


@pytest.mark.cuda
def test_resnet_recorded_trainer_step_through_the_pair_on_card(card):
    """Trainer steps under record() through the graph pair, BatchNorm
    writing its statistics in the forward graph: bitwise equal to
    eager."""
    chip_smoke.resnet_recorded_trainer_check(card, "resnet18_v1", 4, 32)



# -- O1-O3: the multi-tensor optimizer kernels (chip_smoke's checks) --------

_OPT_NAMES = [n for n, _ in chip_smoke.opt_specs()]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["adamw", "adam", "op"])
@pytest.mark.parametrize("name", _OPT_NAMES)
def test_multi_adamw_matches_plain_on_card(card, name, form):
    """O1 against its plain version: f32 within 2 ulp, bf16 and f16 equal
    in 99.9% of elements and within 1 ulp."""
    ok, _, readings = chip_smoke.opt_compare(
        oo, card, dict(chip_smoke.opt_specs())[name], 5,
        chip_smoke.run_adamw, oo.multi_adamw, oo._multi_adamw_ref, form)
    assert ok, readings


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["plain", "momentum", "nesterov",
                                  "preloaded"])
@pytest.mark.parametrize("name", _OPT_NAMES)
def test_multi_sgd_matches_plain_on_card(card, name, form):
    ok, _, readings = chip_smoke.opt_compare(
        oo, card, dict(chip_smoke.opt_specs())[name], 6,
        chip_smoke.run_sgd, oo.multi_sgd, oo._multi_sgd_ref, form)
    assert ok, readings


@pytest.mark.cuda
@pytest.mark.parametrize("plant", [None, float("inf"), float("nan")],
                         ids=["finite", "inf", "nan"])
def test_multi_sum_sq_matches_f64_and_flags_on_card(card, plant):
    """O3 within 1e-6 of an f64 host sum on every list, its flag exact,
    and two runs bitwise equal (no float atomics)."""
    for name, arrays in chip_smoke.sum_sq_lists(card):
        ok, rel = chip_smoke.sum_sq_check(oo, arrays, plant)
        assert ok, (name, rel)
        a, b = oo.multi_sum_sq(arrays), oo.multi_sum_sq(arrays)
        # bit patterns: a planted nan makes a sum nan, which equals nothing
        assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) \
            and torch.equal(a[1], b[1]), name


@pytest.mark.cuda
def test_optimizer_checks_catch_a_table_that_skips_its_last_tensor(card):
    from mxnet_tpu_torch.ops import _build

    path = _build.build(oo._SOURCE, defines=("MXTT_SKIP_LAST=1",))
    spec = dict(chip_smoke.opt_specs())["bf16"]
    with chip_smoke.planted_optimizer_library(oo, path):
        assert not chip_smoke.opt_compare(
            oo, card, spec, 7, chip_smoke.run_adamw, oo.multi_adamw,
            oo._multi_adamw_ref, "adamw")[0]
        assert not chip_smoke.opt_compare(
            oo, card, spec, 7, chip_smoke.run_sgd, oo.multi_sgd,
            oo._multi_sgd_ref, "momentum")[0]
        assert not chip_smoke.sum_sq_check(oo, chip_smoke.opt_buffers(
            card, chip_smoke.OPT_SIZES, torch.float32, 77, "g"))[0]


@pytest.mark.cuda
def test_optimizer_wrappers_raise_on_strides_and_never_run_plain(card):
    w = torch.randn(64, 48, device=card)
    with pytest.raises(MXNetError, match="strides"):
        oo.multi_adamw([w], [torch.randn(48, 64, device=card).t()],
                       [torch.zeros_like(w)], [torch.zeros_like(w)], [1.0],
                       [0.0], lr=torch.ones((), device=card),
                       t=torch.ones((), dtype=torch.int32, device=card))
    before = oo.multi_sgd.launches
    oo.multi_sgd([w], [torch.randn_like(w)], None, [0.1], [0.0])
    assert oo.multi_sgd.launches == before + 1
    with pytest.raises(MXNetError, match="not dense"):
        oo.multi_sum_sq([torch.randn(64, 96, device=card)[:, ::2]])


@pytest.mark.cuda
def test_optimizer_launch_counts_are_the_kernels_launched_on_card(card):
    """The counts come from the library: one O1/O2 launch per table of a
    dtype group, two O3 kernels per table (partial sums, then the
    finish) and one where a table holds only empty tensors."""
    f32, bf16 = torch.float32, torch.bfloat16
    sizes = [7] * 1100                  # more than one table of each
    ws = [torch.randn(n, device=card, dtype=f32 if i % 2 else bf16)
          for i, n in enumerate(sizes)]
    lr = torch.full((), 1e-3, device=card)
    t = torch.ones((), dtype=torch.int32, device=card)
    ones, zeros = [1.0] * len(ws), [0.0] * len(ws)
    counts = {}
    for name, call in (
            ("O1", lambda: oo.multi_adamw(
                ws, [torch.randn_like(w) for w in ws],
                [torch.zeros_like(w) for w in ws],
                [torch.zeros_like(w) for w in ws], ones, zeros, lr=lr,
                t=t)),
            ("O2", lambda: oo.multi_sgd(ws, [torch.randn_like(w)
                                             for w in ws], None, ones,
                                        zeros, lr=lr)),
            ("O3", lambda: oo.multi_sum_sq(ws)),
            ("O3 empty", lambda: oo.multi_sum_sq(
                [torch.zeros(0, device=card)]))):
        chip_smoke.reset_opt_counts(oo)
        call()
        counts[name] = chip_smoke.opt_counts(oo)
    # 550 tensors a dtype: 2 tables of 448 (O1) or 512 (O2) each;
    # 1,100 tensors in 2 tables of 1,024 (O3)
    assert counts["O1"] == {"O1": 4, "O2": 0, "O3": 0}
    assert counts["O2"] == {"O1": 0, "O2": 4, "O3": 0}
    assert counts["O3"] == {"O1": 0, "O2": 0, "O3": 4}
    assert counts["O3 empty"] == {"O1": 0, "O2": 0, "O3": 1}


@pytest.mark.cuda
def test_graphed_train_step_with_clip_global_norm_bitwise_equal_eager_on_card(
        card):
    """The update through O1 and the clip's norm through O3, graphed and
    eager: losses and weights bitwise equal, both kernels launched."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 512, (2, 16)).astype(np.int32)
    y = rng.integers(0, 512, (2, 16)).astype(np.float32)
    runs = []
    for graphs in (False, True):
        before = chip_smoke.opt_counts(oo)
        net, step = _train_step(card, graphs, clip=0.5)
        losses = [step.step(x, y).clone() for _ in range(4)]
        losses.append(step.step_n(3, x, y).clone())
        after = chip_smoke.opt_counts(oo)
        assert after["O1"] >= before["O1"] + 7
        assert after["O3"] >= before["O3"] + 7
        runs.append((net, losses))
    (e_net, e_loss), (g_net, g_loss) = runs
    assert all(torch.equal(a, b) for a, b in zip(e_loss, g_loss))
    for (name, a), b in zip(e_net.named_parameters(), g_net.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_grad_req_add_accumulates_through_the_pair_on_card(card):
    """``grad_req="add"`` at bert_small through the hybridized graph
    pair: two half batches give the full batch's gradients within 1e-4,
    and ``zero_grad()`` leaves zeros."""
    assert chip_smoke.gluon_add_check(card) <= 1e-4


@pytest.mark.cuda
def test_grad_req_null_change_after_a_capture_on_card(card):
    """A ``grad_req="null"`` change after a capture takes a new capture
    (its gradient signature changed); gradients bitwise equal to eager
    and the frozen weight's ``None``."""
    chip_smoke.gluon_null_change_check(card)


@pytest.mark.cuda
def test_graphed_train_step_over_a_pair_holding_nodes_on_card(card):
    """A graphed ``JitTrainStep`` captured over a net whose hybridized
    pair still holds its parameters' ``AccumulateGrad`` nodes: losses and
    weights bitwise equal to the eager step's."""
    chip_smoke.held_nodes_jit_check(card)


# -- the vision families and saved signatures (S5c, S6b) ---------------------

@pytest.mark.cuda
def test_vision_families_agree_with_the_host_on_card(card):
    chip_smoke.vision_parity(card)


@pytest.mark.cuda
def test_hybridized_densenet_bitwise_equal_eager_on_card(card):
    chip_smoke.densenet_hybrid_check(card)


@pytest.mark.cuda
def test_aot_round_trips_through_fresh_processes_on_card(card):
    """The hybridized Inception-v3, a causal bf16 Llama (K1 replayed)
    and the graphed Inception-v3 step, each bitwise equal to the
    exporting process's with no capture at call time; the loader's
    NVRTC compile a cache hit."""
    chip_smoke.vision_round_trips(card)


@pytest.mark.cuda
def test_load_executable_captures_ahead_and_steps_on_nothing_on_card(
        card, tmp_path):
    """In one process, a second step over a fresh net of the same
    architecture: ``load_executable`` captures the step (one capture)
    and leaves the weights, running statistics, momentum and count as
    they were; after ``load_states`` its first step is a replay equal
    to the first step's second, bitwise."""
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision

    def make():
        net = vision.DenseNet(16, 8, [2, 2], classes=10, device=card)
        net.initialize(generator=torch.Generator(device=card).manual_seed(0))
        return net, parallel.JitTrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9})

    x, y = chip_smoke._resnet_batch(card, 4, 56, 2)
    paths = [str(tmp_path / n) for n in ("s.aot", "s.st", "s.params")]
    with chip_smoke.exact_convs():
        net, step = make()
        chip_smoke.resnet_shapes(net, x)
        step.step(x, y)
        step.save_executable(paths[0])
        step.save_states(paths[1])
        net.save_parameters(paths[2])
        want = step.step(x, y).clone()
        weights = [p.detach().clone() for p in step._params]
        net2, step2 = make()
        net2.load_parameters(paths[2])
        before = [t.clone() for t in net2.state_dict().values()]
        step2.load_executable(paths[0], x, y)
        assert all(torch.equal(a, b) for a, b in
                   zip(before, net2.state_dict().values()))
        assert int(step2._count) == 0 and step2.stats()["captures"] == 1
        assert not any(bool(s.any()) for s in step2._opt_state
                       if s is not None)
        step2.load_states(paths[1])
        got = step2.step(x, y)
        st = step2.stats()
    assert (st["captures"], st["replays"]) == (1, 1)
    assert torch.equal(got, want)
    assert all(torch.equal(p, w) for p, w in zip(step2._params, weights))


# -- the op tail: DCGAN, the ops and the samplers on the card -------------


@pytest.mark.cuda
def test_op_tail_matches_host_on_card(card):
    """Every op of the op tail but the samplers: ordering, indexing and
    integer results bitwise (ties, Embedding's out-of-range ids), f32
    within 1e-5, linalg within 1e-4 of the host's."""
    rows = chip_smoke.op_tail_checks(card)
    bad = [r for r in rows if not r[4]]
    assert len(rows) > 60 and not bad, bad


@pytest.mark.cuda
def test_embedding_ids_out_of_range_leave_the_context_usable_on_card(card):
    """F3 on the card: no device-side assert; NaN rows, and the process's
    CUDA context takes further work."""
    from mxnet_tpu_torch.ops import nn as ops_nn

    ids = torch.tensor([0, -1, 3, -4, 1.7], device=card)
    got = ops_nn._embedding(ids, torch.ones(3, 2, device=card))
    torch.cuda.synchronize()
    assert torch.isnan(got[2:4]).all() and (got[[0, 1, 4]] == 1).all()
    assert float(torch.ones(4, device=card).sum()) == 4.0


@pytest.mark.cuda
def test_samplers_match_their_distributions_on_card(card):
    readings = chip_smoke.draw_readings(card, 1 << 20, 23)
    bad = {k: r for k, r in readings.items() if k != "shuffle"
           and not chip_smoke.draw_ok(r)}
    assert not bad, bad
    assert readings["shuffle"]["permutes"]


@pytest.mark.cuda
def test_seeded_draws_repeat_bitwise_on_card(card):
    import mxnet_tpu_torch as mx

    same, differ = chip_smoke.seeded_draws_repeat(mx, card)
    assert same and differ


@pytest.mark.cuda
def test_hybridized_dropout_draws_afresh_at_each_replay_on_card(card):
    import mxnet_tpu_torch as mx

    differ, same, st = chip_smoke.dropout_graph_masks(mx, card)
    assert st["captures"] == 1 and st["replays"] >= 4, st
    assert differ and same


@pytest.mark.cuda
def test_dcgan_iteration_matches_host_on_card(card):
    """Full width at batch 32, f32, TF32 off: one D-and-G iteration on
    the card held to the host's f64 run (``chip_smoke.gan_parity``)."""
    import mxnet_tpu_torch as mx

    chip_smoke.gan_parity(mx, card)


@pytest.mark.cuda
def test_dcgan_seeded_runs_bitwise_equal_on_card(card):
    import mxnet_tpu_torch as mx

    chip_smoke.gan_repro(mx, card)


@pytest.mark.cuda
def test_dcgan_transposed_convolutions_run_in_bf16_under_amp_on_card(card):
    import mxnet_tpu_torch as mx

    chip_smoke.gan_amp(mx, card)


# -- O4 box_nms and the detection slice ------------------------------------------


def _nms_case(card, case, b=3, n=1500):
    g = torch.Generator()
    g.manual_seed(len(case))
    xy = torch.rand(b, n, 2, generator=g) * 0.7
    boxes = torch.cat([xy, xy + 0.02 + torch.rand(b, n, 2, generator=g)
                       * 0.3], 2)
    valid = torch.rand(b, n, generator=g) > 0.05
    thresh = 0.5
    if case == "ties":
        # repeated boxes: IoU 1 with every copy
        boxes[:, 1::2] = boxes[:, 0::2][:, :boxes[:, 1::2].shape[1]]
    elif case == "threshold":
        base = torch.tensor([[0, 0, 2, 1], [0, 0, 2, 2], [0, 0, 1, 1],
                             [0, 0, 4, 1]], dtype=torch.float32)
        boxes = torch.cat([base * 2.0 ** -k for k in range(60)])[None] \
            .expand(b, -1, -1).contiguous()
        valid = torch.ones(b, boxes.shape[1], dtype=torch.bool)
    return boxes.to(card), valid.to(card), thresh


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "ties", "threshold"])
def test_o4_keep_mask_equals_the_plain_version_on_card(card, case):
    """O4 builds, launches once a call (its count), and its keep mask
    equals the plain version's bit for bit: random boxes, repeated boxes
    (ties at IoU 1), and pairs whose IoU is exactly the threshold."""
    from mxnet_tpu_torch.ops import box_nms

    boxes, valid, t = _nms_case(card, case)
    before = box_nms.nms_keep.launches
    got = box_nms.nms_keep(boxes, valid, t)
    assert box_nms.nms_keep.launches == before + 1
    want = box_nms.nms_keep_ref(boxes, valid, t)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got, want)


@pytest.mark.cuda
def test_o4_checks_of_the_smoke_on_card(card):
    chip_smoke.o4_checks(card)


@pytest.mark.cuda
def test_box_nms_op_matches_the_host_bitwise_on_card(card):
    from mxnet_tpu_torch.ops import registry

    rs = np.random.RandomState(0)
    data = np.concatenate(
        [rs.randint(0, 3, (2, 900, 1)), np.round(rs.uniform(
            0, 1, (2, 900, 1)) * 8) / 8, rs.uniform(0, 0.7, (2, 900, 2))],
        2).astype(np.float32)
    data = np.concatenate([data, data[..., 2:4] + rs.uniform(
        0.02, 0.3, (2, 900, 2)).astype(np.float32)], 2)
    fwd = registry.get("_contrib_box_nms").forward
    got = fwd(torch.from_numpy(data).to(card), overlap_thresh=0.45)
    want = fwd(torch.from_numpy(data), overlap_thresh=0.45)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_ssd_steps_match_the_host_on_card(card):
    """The SSD at full width, batch 2 at 300 x 300: three graphed
    ``JitTrainStep`` adam steps (``MultiBoxTarget`` captured) held to the
    host's f64 run (``chip_smoke.ssd_parity``)."""
    import mxnet_tpu_torch as mx

    chip_smoke.ssd_parity(mx, card)


@pytest.mark.cuda
def test_attention_ops_through_nd_contrib_launch_k1_and_k4_on_card(card):
    import mxnet_tpu_torch as mx

    assert chip_smoke.attention_op_checks(mx, card)


@pytest.mark.cuda
def test_custom_op_and_while_loop_recorded_match_host_on_card(card):
    import mxnet_tpu_torch as mx

    assert chip_smoke.recorded_control_checks(mx, card)


@pytest.mark.cuda
def test_host_reads_raise_under_a_capture_on_card(card):
    """``boolean_mask``, ``cond`` and a recorded ``while_loop`` inside a
    hybridized block's captured call raise ``MXNetError``, and the card
    takes further work."""
    import mxnet_tpu_torch as mx

    assert chip_smoke.capture_refusal_checks(mx, card)


# -- O4's cluster route, the two-pass route, and F8 on the card ------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.o4_cases())))
@pytest.mark.parametrize("route", ["cluster", "two_pass"])
def test_o4_routes_equal_the_plain_version_on_card(card, route, case):
    """Each route's keep mask equals ``nms_keep_ref``'s bit for bit on the
    smoke's cases: random, repeated rows, one box repeated, IoU exactly at
    the threshold, sparse past one word, a negative threshold, NaN and
    infinite corners."""
    from mxnet_tpu_torch.ops import box_nms

    label, boxes, valid, t = chip_smoke.o4_cases()[case]
    boxes, valid = boxes.to(card), valid.to(card)
    got = box_nms._nms_keep(boxes, valid, t, route)
    want = box_nms.nms_keep_ref(boxes, valid, t)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got, want), label


@pytest.mark.cuda
def test_o4_above_the_cluster_size_takes_the_two_pass_route_on_card(card):
    """One image of ``CLUSTER_MAX_BOXES + 1`` boxes: the size rule gives
    the two-pass route, which equals the plain version; the cluster route
    refuses it."""
    from mxnet_tpu_torch.ops import box_nms

    n = box_nms.CLUSTER_MAX_BOXES + 1
    assert box_nms.route_for(n) == "two_pass"
    assert box_nms.route_for(n - 1) == "cluster"
    g = torch.Generator()
    g.manual_seed(9)
    xy = torch.rand(1, n, 2, generator=g) * 0.9
    boxes = torch.cat([xy, xy + 0.01 + torch.rand(1, n, 2, generator=g)
                       * 0.05], 2).to(card)
    valid = (torch.rand(1, n, generator=g) > 0.05).to(card)
    before = box_nms.nms_keep.launches
    got = box_nms.nms_keep(boxes, valid, 0.5)
    assert box_nms.nms_keep.launches == before + 1
    want = box_nms.nms_keep_ref(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(MXNetError):
        box_nms._nms_keep(boxes, valid, 0.5, "cluster")


@pytest.mark.cuda
def test_o4_cluster_route_at_its_size_limit_on_card(card):
    """Two images of exactly ``CLUSTER_MAX_BOXES`` boxes (256 words: 32
    local words a CTA, the largest shared memory and flag arrays at
    their full extent) go through the cluster route, one launch, and
    equal the plain version bit for bit."""
    from mxnet_tpu_torch.ops import box_nms

    n = box_nms.CLUSTER_MAX_BOXES
    assert box_nms.route_for(n) == "cluster"
    g = torch.Generator()
    g.manual_seed(10)
    xy = torch.rand(2, n, 2, generator=g) * 0.9
    boxes = torch.cat([xy, xy + 0.01 + torch.rand(2, n, 2, generator=g)
                       * 0.08], 2).to(card)
    valid = (torch.rand(2, n, generator=g) > 0.05).to(card)
    before = box_nms.nms_keep.launches
    got = box_nms.nms_keep(boxes, valid, 0.5)
    assert box_nms.nms_keep.launches == before + 1
    want = box_nms.nms_keep_ref(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert 0 < int(want.sum()) < want.numel()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [-0.5, 0.0, 0.3])
def test_o4_negative_zero_threshold_and_nonfinite_boxes_on_card(card, thresh):
    """Thresholds below, at and above 0 (the divide is skipped only at or
    above 0) on boxes with NaN, infinite and empty corners: both routes
    equal the plain version."""
    from mxnet_tpu_torch.ops import box_nms

    g = torch.Generator()
    g.manual_seed(11)
    xy = torch.rand(3, 700, 2, generator=g) * 0.7
    boxes = torch.cat([xy, xy + torch.rand(3, 700, 2, generator=g) * 0.3],
                      2)
    boxes[:, 1::13, 2] = float("nan")
    boxes[:, 2::19, 3] = float("inf")
    boxes[:, 4::23, :2] = -float("inf")
    boxes[:, 6::29, 2:] = boxes[:, 6::29, :2]           # zero area
    boxes, valid = boxes.to(card), torch.ones(3, 700, dtype=torch.bool,
                                              device=card)
    want = box_nms.nms_keep_ref(boxes, valid, thresh)
    for route in ("cluster", "two_pass"):
        got = box_nms._nms_keep(boxes, valid, thresh, route)
        assert torch.equal(got, want), route


@pytest.mark.cuda
def test_multibox_detection_replays_in_a_captured_graph_on_card(card):
    """``MultiBoxDetection`` (O4 on the cluster route) captured in a CUDA
    graph: its replay on new inputs equals the eager call bit for bit,
    and the capture counted one O4 launch."""
    from mxnet_tpu_torch.ops import box_nms, registry

    fwd = registry.get("_contrib_MultiBoxDetection").forward
    g = torch.Generator()
    g.manual_seed(12)
    a = 2000
    xy = torch.rand(1, a, 2, generator=g) * 0.8
    anchors = torch.cat([xy, xy + 0.05 + torch.rand(1, a, 2, generator=g)
                         * 0.15], 2).to(card)

    def inputs():
        logits = torch.randn(4, 6, a, generator=g) * 2.0
        return (torch.softmax(logits, 1).to(card),
                (torch.randn(4, a * 4, generator=g) * 0.3).to(card))

    probs, loc = inputs()
    static = [probs.clone(), loc.clone()]
    fwd(*static, anchors, nms_threshold=0.45)           # builds, warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = box_nms.nms_keep.launches
    with torch.cuda.graph(graph):
        out = fwd(*static, anchors, nms_threshold=0.45)
    assert box_nms.nms_keep.launches == before + 1
    for _ in range(2):
        probs, loc = inputs()
        static[0].copy_(probs)
        static[1].copy_(loc)
        graph.replay()
        want = fwd(probs, loc, anchors, nms_threshold=0.45)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def _vae_block(gluon, nn):
    """``examples/autoencoder/train_vae.py``'s VAE at small widths as a
    ``HybridBlock`` whose ``forward`` is written on ``mx.nd``, the noise
    passed in (so eager and hybridized calls compare)."""
    class VAE(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.enc = nn.Dense(16, activation="relu", in_units=12)
                self.mu = nn.Dense(4, in_units=16)
                self.logvar = nn.Dense(4, in_units=16)
                self.dec = nn.Dense(12, in_units=4)

        def forward(self, x, eps):
            h = self.enc(x)
            mu, logvar = self.mu(h), self.logvar(h)
            z = mu + (0.5 * logvar).exp() * eps
            return self.dec(z), mu, logvar

    return VAE


@pytest.mark.cuda
def test_user_forward_on_nd_records_eager_and_hybridized_on_card(card):
    """F8 on the card: a user's ``forward`` on NDArrays under
    ``record()``, eagerly and hybridized (the graph pair), gives the same
    loss and gradients; the example's own ``nd.random.normal`` runs too."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon import nn

    rng = np.random.default_rng(13)
    x = nd.array(rng.uniform(size=(8, 12)).astype(np.float32), ctx=mx.gpu(0))
    eps = nd.array(rng.standard_normal((8, 4)).astype(np.float32),
                   ctx=mx.gpu(0))
    net = _vae_block(gluon, nn)()
    net.initialize(mx.init.Xavier())

    def step():
        with autograd.record():
            logits, mu, logvar = net(x, eps)
            loss = ((logits - x) ** 2).sum() + (
                -0.5 * (1 + logvar - mu ** 2 - logvar.exp())).sum()
        loss.backward()
        return float(loss.asscalar()), [p.grad().asnumpy().copy()
                                        for p in net.collect_params().values()]

    eager = step()
    net.hybridize()
    for _ in range(3):                 # eager, capture, replay
        hybrid = step()
    assert net.stats()["captures"] >= 1
    np.testing.assert_allclose(hybrid[0], eager[0], rtol=1e-6)
    for g, w in zip(hybrid[1], eager[1]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)

    class Sampled(gluon.Block):
        def __init__(self):
            super().__init__()
            self.mu = nn.Dense(4, in_units=12)

        def forward(self, x):
            mu = self.mu(x)
            return mu + nd.random.normal(0, 1, shape=mu.shape)

    blk = Sampled()
    blk.initialize()
    with autograd.record():
        out = blk(x)
        total = out.sum()
    total.backward()
    assert out.shape == (8, 4) and out.context == mx.gpu(0)
    assert np.isfinite(blk.mu.weight.grad().asnumpy()).all()


# -- O5 and O6: the int8 products (quantization) ------------------------------------


_INT8_EDGE_CASES = chip_smoke.int8_cases([])


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_INT8_EDGE_CASES)),
                         ids=[c[0] for c in _INT8_EDGE_CASES])
def test_int8_kernels_equal_their_plain_versions_on_card(card, case):
    """O5 and O6 at the smoke's edge cases (the stem, groups, depthwise,
    stride 2 with padding, dilation, tails, misaligned s8 and f32 views,
    +-inf, split K, N 1,000, BERT's FFN), bitwise in both A modes and
    both epilogues, one launch a call."""
    from mxnet_tpu_torch.ops import int8_ops

    label, kind, spec = _INT8_EDGE_CASES[case]
    x, w, bias_f, bias_i, xf, scale = chip_smoke.int8_inputs(card, kind,
                                                             spec, case)
    wrapper = int8_ops.int8_conv if kind == "conv" else int8_ops.int8_gemm
    for what, a, bias, denom, sc in chip_smoke.int8_variants(
            x, w, bias_f, bias_i, xf, scale):
        before = wrapper.launches
        got = chip_smoke.int8_run(kind, spec, a, w, bias, denom, False, sc)
        assert wrapper.launches == before + 1
        want = chip_smoke.int8_run(kind, spec, a, w, bias, denom, True, sc)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), \
            (label, what)


@pytest.mark.cuda
def test_int8_planted_fault_is_caught_in_every_case_on_card(card):
    """A build that drops the last K tile of every split differs from the
    plain version in every edge case, A mode and epilogue."""
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import int8_ops

    path = _build.build(int8_ops._SOURCE, defines=("MXTT_SKIP_LAST=1",))
    chip_smoke.planted_int8_fault(card, [], path)


@pytest.mark.cuda
def test_int8_routes_are_counted_by_route_and_mode_on_card(card):
    """The f32 mode takes the wgmma route (its stem's 3 channels, a
    channel-first view, a misaligned view included) but for depthwise
    convolutions; the s8 mode takes it where C/G is a multiple of 16 and
    the operands are aligned, the mma_sync route elsewhere."""
    from mxnet_tpu_torch.ops import int8_ops as io

    def s8(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8,
                             device=card)

    xf = torch.randn(2, 3, 16, 16, device=card).permute(0, 2, 3, 1)
    runs = [
        (lambda: io.int8_conv(xf, s8(8, 3, 3, 3), pad=(1, 1), denom=2.0,
                              scale=20.0), "int8_conv", "wgmma_f32"),
        (lambda: io.int8_conv(torch.randn(2, 8, 8, 16, device=card),
                              s8(16, 3, 3, 1), num_group=16, denom=2.0,
                              scale=20.0), "int8_conv", "mma_sync_f32"),
        (lambda: io.int8_conv(s8(2, 8, 8, 32), s8(16, 1, 1, 32)),
         "int8_conv", "wgmma_s8"),
        (lambda: io.int8_conv(s8(2, 8, 8, 3), s8(16, 1, 1, 3)),
         "int8_conv", "mma_sync_s8"),
        (lambda: io.int8_gemm(s8(33 * 96 + 1)[1:].view(33, 96),
                              s8(8, 96)), "int8_gemm", "mma_sync_s8"),
        (lambda: io.int8_gemm(torch.randn(4, 96, device=card)[:, 1:95],
                              s8(8, 94), denom=3.0, scale=9.0),
         "int8_gemm", "wgmma_f32"),
    ]
    for run, name, key in runs:
        io.zero_counts()
        run()
        fn = getattr(io, name)
        assert fn.launches == 1 and getattr(fn, key) == 1, (name, key)
        assert sum(io.route_counts(fn).values()) == 1


@pytest.mark.cuda
def test_scalar_divisions_are_true_divisions_on_card(card):
    """F13: ``_div_scalar``, ``_rdiv_scalar`` and NDArray ``/`` with a
    Python number on the card equal the host's true f32 division."""
    import mxnet_tpu_torch as mx

    assert chip_smoke.scalar_division_checks(mx, card)


@pytest.mark.cuda
def test_int8_checks_of_the_smoke_at_resnet50s_shapes_on_card(card):
    """Every distinct convolution of ResNet-50 v1 at batch 2, as the
    smoke holds them."""
    with chip_smoke.exact_convs():
        net = chip_smoke.resnet_net(card, "resnet50_v1", 17)
        shapes = chip_smoke.quant_conv_shapes(
            net, chip_smoke.quant_images(card, 2, 40))
    assert len(shapes) == 53
    assert chip_smoke.int8_checks(card, shapes) == 0


@pytest.mark.cuda
def test_quantized_ops_nchw_match_the_host_on_card(card):
    chip_smoke.quantized_op_checks(card)


@pytest.mark.cuda
def test_entropy_calibration_on_card_equals_the_host_search(card):
    """The entropy calibrator's histogram counted on the card (values on
    the bin edges and at the maximum included) and its thresholds equal
    ``np.histogram`` and ``_get_optimal_threshold`` on the host, bitwise."""
    from mxnet_tpu_torch.contrib import quantization as q

    rs = np.random.RandomState(1)
    edges = np.histogram(np.zeros(0, np.float32), bins=1001,
                         range=(0, 3.0))[1]
    vals = np.concatenate([rs.uniform(0, 3, 20000).astype(np.float32),
                           edges, np.float32([3.0, 0.0])])
    parts = [torch.from_numpy(vals[:7000]).to(card),
             torch.from_numpy(vals[7000:]).to(card)]
    got, _ = q._device_histogram(parts, 1001, 3.0)
    np.testing.assert_array_equal(
        got, np.histogram(vals, bins=1001, range=(0, 3.0))[0])
    for seed in range(3):
        rs = np.random.RandomState(seed)
        batches = [np.maximum(rs.standard_normal((4, 64, 7, 7)) * 2, 0)
                   .astype(np.float32) for _ in range(2)]
        cal = q._Calibrator("entropy")
        for b in batches:
            cal.observe("x", torch.from_numpy(b).to(card))
        assert cal.threshold("x") == q._get_optimal_threshold(batches)


@pytest.mark.cuda
def test_int8_kernels_raise_on_what_they_do_not_take_on_card(card):
    from mxnet_tpu_torch.ops import int8_ops

    a = torch.zeros(4, 32, dtype=torch.int8, device=card)
    with pytest.raises(MXNetError, match="bias"):
        int8_ops.int8_gemm(a, a, bias=torch.zeros(4, device="cpu"),
                           denom=2.0)
    with pytest.raises(MXNetError, match="operands"):
        int8_ops.int8_gemm(a, a.cpu())


@pytest.mark.cuda
def test_quantize_net_v2_rebuilds_a_captured_net_on_card(card):
    """R10 on the card: a hybridized net that has captured its graph is
    calibrated as an eager copy is (equal thresholds), and its next
    calls capture the int8 path: hybridized logits bitwise equal to
    eager, unlike the f32 net's, with O6 launched 20 times and O5 once
    a forward, replays included."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.ops import int8_ops

    def net():
        return chip_smoke.resnet_net(card, "resnet18_v1", 5, thumbnail=True,
                                     classes=10)

    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    calib = [torch.rand(4, 3, 32, 32, generator=g).to(card)
             for _ in range(2)]
    x = torch.rand(4, 3, 32, 32, generator=g).to(card)
    with chip_smoke.exact_convs():
        hyb, eager, f32 = net(), net(), net()
        hyb.hybridize()
        with torch.no_grad(), autograd.predict_mode():
            for _ in range(3):
                hyb(calib[0])
            want_f32 = f32(x)
        assert hyb.stats()["captures"] >= 1
        q.quantize_net_v2(hyb, calib_data=calib)
        q.quantize_net_v2(eager, calib_data=calib)
        hb, eb = chip_smoke.quant_blocks(hyb), chip_smoke.quant_blocks(eager)
        assert len(hb) == 21 and hb.keys() == eb.keys()
        assert all(hb[p]._threshold == eb[p]._threshold for p in hb)
        int8_ops.zero_counts()
        with torch.no_grad(), autograd.predict_mode():
            outs = [hyb(x) for _ in range(4)]
            want = eager(x)
        torch.cuda.synchronize()
    assert hyb.stats()["replays"] >= 1
    assert all(torch.equal(o, want) for o in outs)
    assert not torch.equal(want, want_f32)
    assert int8_ops.int8_conv.launches == 20 * 5
    assert int8_ops.int8_gemm.launches == 5
    # the layers quantize in the kernels' load: the wgmma route, f32 mode
    assert int8_ops.int8_conv.wgmma_f32 == 20 * 5
    assert int8_ops.int8_gemm.wgmma_f32 == 5


# -- mx.np on the card -------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.np_card_cases())),
                         ids=[c[0] for c in chip_smoke.np_card_cases()])
def test_np_functions_on_card_match_the_host(card, case):
    """Each ``mx.np`` case on the card against the port on the host:
    ``mx.np`` arrays of the host's dtypes and shapes, elementwise and
    indexing results bitwise, transcendental ones within 1e-6 and
    reductions within 1e-5 of the largest value."""
    import mxnet_tpu_torch as mx

    _, ok = chip_smoke.np_card_checks(
        mx, card, [chip_smoke.np_card_cases()[case]])
    assert ok


@pytest.mark.cuda
def test_np_call_replays_the_ndarray_calls_graph_on_card(card):
    """A hybridized block called with ``mx.np`` arrays after NDArrays
    gives ``mx.np`` arrays and replays the NDArray call's graph: the
    capture count is unchanged and the outputs are bitwise equal."""
    import mxnet_tpu_torch as mx

    assert chip_smoke.np_graph_class_check(mx, card)


@pytest.mark.cuda
def test_np_host_reads_raise_under_a_capture_on_card(card):
    """``unique``, ``nonzero``, ``bincount`` and ``delete`` inside a
    captured call raise ``MXNetError`` naming the op; the card takes
    further work."""
    import mxnet_tpu_torch as mx

    assert chip_smoke.np_capture_refusals(mx, card)


# -- O7 csr_dot and O8 rsp_lazy_update (sparse storage) ----------------------


def _csr(rng, m, n, per_row, empty_rows=()):
    """A random CSR matrix on the host: ``per_row`` sorted distinct columns
    a row (none in ``empty_rows``), f32 values."""
    indptr, cols = [0], []
    for r in range(m):
        k = 0 if r in empty_rows else min(per_row, n)
        cols.extend(sorted(rng.choice(n, size=k, replace=False).tolist()))
        indptr.append(len(cols))
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    return (torch.from_numpy(vals), torch.tensor(indptr, dtype=torch.int64),
            torch.tensor(cols, dtype=torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("kdim", [1, 128])
@pytest.mark.parametrize("m,n,per_row", [(300, 1000, 22), (64, 50, 0),
                                         (33, 7, 7), (0, 3, 0)])
def test_csr_dot_matches_plain_on_card(card, transpose_a, kdim, m, n,
                                       per_row):
    """O7 in both modes against its plain version: K 1 and 128, rows with
    no nonzeros, nnz 0, full rows and no rows (no kernel launched; the
    transposed output zeroed); within 1e-5 of the largest value (the sums
    run in another order, transposed by atomics)."""
    from mxnet_tpu_torch.ops import sparse_ops as sops

    rng = np.random.default_rng(m + kdim)
    data, indptr, cols = (t.to(card) for t in _csr(
        rng, m, n, per_row, empty_rows=(0, 5, m - 1)))
    rhs = torch.from_numpy(rng.standard_normal(
        (m if transpose_a else n, kdim)).astype(np.float32)).to(card)
    before = sops.csr_dot.launches
    got = sops.csr_dot(data, indptr, cols, rhs, (m, n), transpose_a)
    assert sops.csr_dot.launches == before + (1 if m else 0)
    want = sops.csr_dot_ref(data, indptr, cols, rhs, (m, n), transpose_a)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    if want.numel():
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-5 * scale


def _csr_case(case):
    """(m, n, indptr, cols) of a named O7 case on the host, its values
    and rhs to be drawn by the caller:
    - ``hot``: 22 columns a row from 4,000, column 7 in every row (the
      worst hot id of a skewed batch);
    - ``tile_edge``: 1,001 rows (no tile size divides it), 5 a row;
    - ``wide_tiles``: 40 rows of 3,000 columns each out of 100,000, so
      that a warp step meets many distinct columns and a row is long;
    - ``out_of_range``: 9 a row with -1, n and n + 5 planted;
    - ``empty``: every third row empty, and the first and last;
    - ``no_nonzeros``: 50 rows, nnz 0."""
    rng = np.random.default_rng(len(case))
    m, n, per_row = {"hot": (2000, 4000, 22), "tile_edge": (1001, 300, 5),
                     "wide_tiles": (40, 100000, 3000),
                     "out_of_range": (200, 90, 9), "empty": (300, 500, 12),
                     "no_nonzeros": (50, 60, 0)}[case]
    indptr, cols = [0], []
    for r in range(m):
        k = per_row
        if case == "empty" and (r % 3 == 0 or r == m - 1):
            k = 0
        row = rng.choice(n, size=k, replace=False)
        if case == "hot" and 7 not in row:
            row[0] = 7
        if case == "out_of_range":
            row[rng.choice(k, 3, replace=False)] = [-1, n, n + 5]
        cols.extend(sorted(row.tolist()))
        indptr.append(len(cols))
    return m, n, torch.tensor(indptr, dtype=torch.int64), \
        torch.tensor(cols, dtype=torch.int64)


def _csr_operands(card, case, kdim, transpose_a, misaligned=False):
    """A case's operands on the card; ``misaligned`` puts rhs one float
    past a 16-byte boundary (the kernels' scalar column path)."""
    m, n, indptr, cols = _csr_case(case)
    rng = np.random.default_rng(kdim)
    data = torch.from_numpy(rng.standard_normal(cols.shape[0]).astype(
        np.float32))
    rows = m if transpose_a else n
    rhs = torch.from_numpy(rng.standard_normal((rows, kdim)).astype(
        np.float32)).to(card)
    if misaligned:
        flat = torch.empty(rows * kdim + 1, device=card)
        flat[1:] = rhs.reshape(-1)
        rhs = flat[1:].view(rows, kdim)
        assert rhs.data_ptr() % 16 and rhs.is_contiguous()
    return (m, n), data.to(card), indptr.to(card), cols.to(card), rhs


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("kdim", [1, 4, 128])
@pytest.mark.parametrize("case", ["hot", "tile_edge", "wide_tiles",
                                  "out_of_range", "empty", "no_nonzeros"])
def test_csr_dot_tile_cases_match_plain_on_card(card, case, kdim,
                                                transpose_a):
    """O7's tile design against its plain version: a column in every row,
    rows across a tile's edge, many distinct columns a warp step and
    long rows, columns outside [0, n) (skipped; the plain
    version is given the same matrix without them), empty rows and nnz
    0; K 1, 4 and 128.  One launch a call; within 1e-5 of the largest
    value (the sums run in another order)."""
    from mxnet_tpu_torch.ops import sparse_ops as sops

    shape, data, indptr, cols, rhs = _csr_operands(card, case, kdim,
                                                   transpose_a)
    keep = (cols >= 0) & (cols < shape[1])
    rows = sops.csr_rows(indptr, shape[0], cols.shape[0])
    ref_indptr = torch.zeros_like(indptr)
    ref_indptr[1:] = torch.bincount(rows[keep], minlength=shape[0]).cumsum(0)
    before = sops.csr_dot.launches
    got = sops.csr_dot(data, indptr, cols, rhs, shape, transpose_a)
    assert sops.csr_dot.launches == before + 1
    want = sops.csr_dot_ref(data[keep], ref_indptr, cols[keep], rhs, shape,
                            transpose_a)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("kdim", [3, 4, 128])
def test_csr_dot_scalar_columns_match_plain_on_card(card, kdim,
                                                    transpose_a):
    """K not a multiple of 4, or rhs off a 16-byte boundary, takes the
    kernels' scalar column path; within 1e-5 of the largest value."""
    from mxnet_tpu_torch.ops import sparse_ops as sops

    shape, data, indptr, cols, rhs = _csr_operands(
        card, "hot", kdim, transpose_a, misaligned=kdim != 3)
    got = sops.csr_dot(data, indptr, cols, rhs, shape, transpose_a)
    want = sops.csr_dot_ref(data, indptr, cols, rhs.contiguous(), shape,
                            transpose_a)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= \
        1e-5 * max(float(want.abs().max()), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kdim", [1, 128])
def test_csr_dot_forward_is_bitwise_repeatable_on_card(card, kdim):
    """The forward has no atomics: two runs are bitwise equal, at the hot
    case and at a Zipf-skewed CTR batch's shape (22 a row)."""
    from mxnet_tpu_torch.ops import sparse_ops as sops

    for case in ("hot", "wide_tiles"):
        shape, data, indptr, cols, rhs = _csr_operands(card, case, kdim,
                                                       False)
        a = sops.csr_dot(data, indptr, cols, rhs, shape)
        b = sops.csr_dot(data, indptr, cols, rhs, shape)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_csr_dot_raises_on_what_it_does_not_take_on_card(card):
    from mxnet_tpu_torch.ops import sparse_ops as sops

    data, indptr, cols = (t.to(card) for t in _csr(
        np.random.default_rng(0), 4, 6, 2))
    rhs = torch.ones(6, 1, device=card)
    with pytest.raises(MXNetError):
        sops.csr_dot(data.double(), indptr, cols, rhs.double(), (4, 6))
    with pytest.raises(MXNetError):
        sops.csr_dot(data, indptr.int(), cols, rhs, (4, 6))
    with pytest.raises(MXNetError):
        sops.csr_dot(data, indptr, cols, torch.ones(5, 1, device=card),
                     (4, 6))


def _o8_inputs(card, route, n, c, ids, seed):
    return chip_smoke.o8_case(card, route, n, c, ids, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sgd", "sgd_mom", "adam", "adagrad"])
@pytest.mark.parametrize("ids", [[0, 3, 4, 9, 31], [], [2, 7, 40, -1]])
def test_rsp_lazy_update_matches_plain_on_card(card, route, ids):
    """O8's routes against its plain version (the optimizer's step in
    plain torch on the gathered rows; it launches neither O1 nor O2):
    weight and states within 1e-6 of the largest value (the same f32
    operations); untouched rows keep their bytes; an empty gradient
    launches nothing; an index out of range (40 and -1 in a 32-row
    table) is skipped."""
    from mxnet_tpu_torch.ops import sparse_ops as sops

    n, c = 32, 24
    opt, w, state, idx, vals, lr, t, step, kw = _o8_inputs(card, route, n,
                                                           c, ids, 3)
    s1, s2 = chip_smoke._clone_state(state), chip_smoke._clone_state(state)
    w1, w2 = w.clone(), w.clone()
    before = sops.rsp_lazy_update.launches
    sops.rsp_lazy_update(w1, idx, vals, s1, route, step, **kw)
    assert sops.rsp_lazy_update.launches == before + (1 if ids else 0)
    held = (oo.multi_sgd.launches, oo.multi_adamw.launches)
    sops.rsp_lazy_update_ref(w2, idx, vals, s2, step)
    assert (oo.multi_sgd.launches, oo.multi_adamw.launches) == held
    torch.cuda.synchronize()
    for a, b in [(w1, w2)] + list(zip(sops._leaves(s1), sops._leaves(s2))):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    keep = torch.ones(n, dtype=torch.bool, device=card)
    inside = [i for i in ids if 0 <= i < n]
    keep[inside] = False
    assert torch.equal(w1[keep], w[keep])
    if inside:
        assert not torch.equal(w1[~keep], w[~keep])


@pytest.mark.cuda
def test_rsp_lazy_update_raises_on_what_it_does_not_take_on_card(card):
    from mxnet_tpu_torch.ops import sparse_ops as sops

    opt, w, state, idx, vals, lr, t, step, kw = _o8_inputs(
        card, "adagrad", 8, 4, [1, 2], 0)
    with pytest.raises(MXNetError):
        sops.rsp_lazy_update(w.double(), idx, vals, state, "adagrad", step,
                             **kw)
    with pytest.raises(MXNetError):
        sops.rsp_lazy_update(w, idx, vals, None, "adagrad", step, **kw)
    with pytest.raises(MXNetError):
        sops.rsp_lazy_update(w, idx, vals, state, "rmsprop", step, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_precision_lazy_update_raises_on_card(card, name, dtype):
    """A half-precision table with a row-sparse gradient on the card, under
    an optimizer that has an O8 route, reaches O8, which takes float32
    only: the step raises, launches nothing and leaves the table as it
    was (no quiet gather-step-scatter in its place)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import sparse_ops as sops

    with mx.gpu(0):
        emb = gluon.nn.Embedding(20, 8, dtype=dtype, sparse_grad=True)
        emb.initialize()
        tr = gluon.Trainer(emb.collect_params(), name,
                           {"learning_rate": 0.1})
        with autograd.record():
            loss = emb(mx.nd.array([[1, 4, 4, 7]])).astype("float32").sum()
        loss.backward()
        assert emb.weight.grad().stype == "row_sparse"
        before = emb.weight.detach().clone()
        launches = sops.rsp_lazy_update.launches
        with pytest.raises(MXNetError, match="rsp_lazy_update"):
            tr.step(1)
    assert sops.rsp_lazy_update.launches == launches
    assert torch.equal(emb.weight.detach(), before)


@pytest.mark.cuda
def test_trainer_lazy_update_on_card_matches_the_host(card):
    """``gluon.Trainer`` with a row-sparse Embedding gradient on the card
    (O8) against the same steps on the host (its plain version), for
    SGD with momentum, Adam and AdaGrad."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 5)).astype(np.float32)
    for name, kw in (("sgd", {"momentum": 0.9}), ("adam", {}),
                     ("adagrad", {})):
        got = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                emb = gluon.nn.Embedding(50, 8, sparse_grad=True)
                emb.initialize()
                emb.weight.set_data(mx.nd.array(table))
                tr = gluon.Trainer(emb.collect_params(), name,
                                   dict(learning_rate=0.1, **kw))
                for _ in range(3):
                    with autograd.record():
                        loss = (emb(mx.nd.array(ids)) ** 2).sum()
                    loss.backward()
                    assert emb.weight.grad().stype == "row_sparse"
                    tr.step(6)
                got.append(emb.weight.data().asnumpy())
        np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_to_dlpack_for_write_aliases_a_card_array(card):
    """A write through ``to_dlpack_for_write``'s capsule shows in the card
    array at once (the export aliases the tensor), and the read export
    aliases it too."""
    import mxnet_tpu_torch as mx

    a = mx.nd.array(np.arange(6, dtype=np.float32), ctx=mx.gpu(0))
    w = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_write())
    assert w.device.type == "cuda" and w.data_ptr() == a.data().data_ptr()
    w += 10.0
    np.testing.assert_array_equal(a.asnumpy(), np.arange(6) + 10.0)
    r = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_read())
    assert r.data_ptr() == a.data().data_ptr()
    np.testing.assert_array_equal((a + 1).asnumpy(), np.arange(6) + 11.0)


# -- the recurrent layers: cuDNN's fused RNN (no hand-written kernel) -------

@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
@pytest.mark.parametrize("mode", chip_smoke.RNN_MODES)
def test_rnn_fused_route_matches_plain_loop_on_card(card, mode,
                                                    bidirectional):
    """``ops.nn.rnn_fused`` (cuDNN) against ``_rnn_plain`` on the card, 2
    layers, f32 with TF32 off: outputs, h_n, c_n and the gradients of
    data, parameters and states, within chip_smoke's RNN_FWD_TOL and
    RNN_GRAD_TOL (``rnn_compare`` raises on a miss)."""
    s = chip_smoke.RNN_SMALL
    with chip_smoke.tf32(False):
        case = chip_smoke.rnn_case(card, mode, bidirectional, s["t"],
                                   s["b"], s["i"], s["h"], s["layers"],
                                   seed=7)
        chip_smoke.rnn_compare(case, mode, bidirectional)


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
def test_hybridized_lstm_layer_matches_eager_on_card(card, bidirectional):
    """A hybridized ``rnn.LSTM`` (2 layers, dropout 0.3 between them in
    train mode) replays its recorded calls as graph pairs, cuDNN's
    kernels inside: outputs, states and gradients equal an eager twin's
    from the same weights and the same generator state, and the counters
    show captured graphs replayed, no call run eagerly."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import rnn

    ctx = mx.gpu(0)
    nets = []
    for _ in range(2):
        net = rnn.LSTM(32, num_layers=2, dropout=0.3, input_size=16,
                       bidirectional=bidirectional)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        nets.append(net)
    with torch.no_grad():
        for a, b in zip(nets[0].parameters(), nets[1].parameters()):
            b.copy_(a)
    nets[1].hybridize()
    rng = np.random.default_rng(4)
    dirs = 2 if bidirectional else 1
    for step in range(4):
        x = rng.standard_normal((7, 5, 16)).astype(np.float32)
        h0 = rng.standard_normal((2 * dirs, 5, 32)).astype(np.float32)
        res = []
        for net in nets:
            torch.cuda.manual_seed(step)
            states = [mx.nd.array(h0, ctx=ctx), mx.nd.zeros_like(
                mx.nd.array(h0, ctx=ctx))]
            with autograd.record():
                out, new = net(mx.nd.array(x, ctx=ctx), states)
                loss = (out * out).sum() + (new[0] * new[1]).sum()
            loss.backward()
            res.append([out.asnumpy(), new[0].asnumpy(), new[1].asnumpy()]
                       + [p.grad.cpu().numpy() for p in net.parameters()])
        for a, b in zip(*res):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    st = nets[1].stats()
    # the first call runs eagerly, the second captures; three replays
    assert st["captures"] == 1 and st["replays"] == 3 \
        and st["backward_replays"] == 3 and st["busy_calls"] == 0, st
    # calls under no_grad in predict mode: one captured forward graph
    x = mx.nd.array(rng.standard_normal((7, 5, 16)).astype(np.float32),
                    ctx=ctx)
    with autograd.predict_mode(), torch.no_grad():
        want = nets[0](x).asnumpy()
        for _ in range(3):
            np.testing.assert_allclose(nets[1](x).asnumpy(), want,
                                       rtol=1e-5, atol=1e-6)
    st = nets[1].stats()
    assert st["captures"] == 2 and st["replays"] == 5, st


@pytest.mark.cuda
@pytest.mark.parametrize("mode", chip_smoke.RNN_MODES)
def test_rnn_op_runs_in_bf16_under_amp_on_card(card, mode):
    """Under AMP bf16 ``nd.RNN`` takes bf16 on the card (it is on the
    target-dtype list) and stays within 2e-2 of its f32 result."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops.nn import rnn_param_size

    ctx = mx.gpu(0)
    rng = np.random.default_rng(9)
    n = rnn_param_size(mode, 2, 12, 16, True)
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.3
              for s in ((9, 4, 12), (n,), (4, 4, 16), (4, 4, 16))]
    ins = [mx.nd.array(a, ctx=ctx)
           for a in arrays[:4 if mode == "lstm" else 3]]
    attrs = dict(state_size=16, num_layers=2, mode=mode, bidirectional=True)
    want = [o.asnumpy() for o in mx.nd.RNN(*ins, **attrs)]
    amp.init("bfloat16")
    try:
        got = mx.nd.RNN(*ins, **attrs)
    finally:
        amp.turn_off()
    for g, w in zip(got, want):
        assert g.data().dtype == torch.bfloat16
        np.testing.assert_allclose(g.asnumpy(), w, rtol=2e-2, atol=2e-2)
