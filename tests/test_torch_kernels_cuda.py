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
