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
from mxnet_tpu_torch.ops import flash_attention as fa
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
