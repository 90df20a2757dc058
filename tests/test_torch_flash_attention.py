"""The port's flash attention (``mxnet_tpu_torch.ops.flash_attention``)
against the JAX package's ``_flash_attention`` on the CPU.

The JAX side runs as its own tests run it: the Pallas kernels through the
interpreter, with explicit blocks.  The port's side runs its plain
versions of K1, K2 and K3 inside the same ``autograd.Function`` that
launches the kernels on the card.  Inputs come from numpy seeds; f32
tolerances are the JAX package's own 2e-4 (the blocked kernels sum in
another order than one einsum).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa


def _inputs(seed, shape_q, shape_kv, dtype=np.float32):
    rs = np.random.RandomState(seed)
    q = (rs.randn(*shape_q) * 0.5).astype(dtype)
    k = (rs.randn(*shape_kv) * 0.5).astype(dtype)
    v = rs.randn(*shape_kv).astype(dtype)
    do = rs.randn(*shape_q).astype(dtype)
    return q, k, v, do


def _port_grads(q, k, v, do, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("t,d,causal,bq,bk", [
    (32, 16, False, 8, 8),
    (64, 32, True, 16, 16),
    (64, 8, True, 8, 32),
    (128, 64, False, 32, 16),
])
def test_grads_match_pallas_kernels(t, d, causal, bq, bk):
    q, k, v, do = _inputs(0, (2, t, d), (2, t, d))
    scale = 1.0 / np.sqrt(d)
    want_out, want = _jax_grads(
        lambda a, b, c: pk._flash_attention(a, b, c, scale, causal, bq, bk),
        q, k, v, do)
    got_out, got = _port_grads(q, k, v, do, scale=scale, causal=causal)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-4, atol=2e-4)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg="d%s (t=%d d=%d causal=%s)"
                                   % (name, t, d, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_out_and_lse_match_the_forward_kernel(causal):
    q, k, v, _ = _inputs(1, (3, 64, 32), (3, 64, 32))
    scale = 1.0 / np.sqrt(32)
    run = functools.partial(pk._flash_pallas, scale=scale, causal=causal,
                            block_q=16, block_k=16)
    out, lse = pk._platform_pick(run, *map(jnp.asarray, (q, k, v)))
    got_out, got_lse = fa._flash_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                         scale, causal)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                               rtol=2e-4, atol=2e-4)
    # the TPU broadcasts lse over 128 lanes; the port keeps it (BH, T)
    assert got_lse.shape == (3, 64)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               rtol=2e-4, atol=2e-4)


def test_bf16_inputs_match_and_keep_their_dtype():
    """bf16 in, bf16 out; both sides round the f32 results to bf16, so
    they differ by about one bf16 ulp (atol 3e-2, rtol 2e-2)."""
    q, k, v, do = _inputs(2, (2, 64, 32), (2, 64, 32))
    want_out, want = _jax_grads(
        lambda a, b, c: pk._flash_attention(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
            c.astype(jnp.bfloat16), 1.0 / np.sqrt(32), True, 16, 16)
        .astype(jnp.float32), q, k, v, do)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=True)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(), want_out,
                               rtol=2e-2, atol=3e-2)
    for name, t, w in zip("qkv", (qt, kt, vt), want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=2e-2,
                                   atol=3e-2, err_msg="d%s" % name)


@pytest.mark.parametrize("t_q,t_kv,blocks", [
    (7, 7, (7, 7)),        # one block spans the whole ragged axis
    (100, 100, (16, 16)),  # does not tile: the JAX op falls back
    (16, 40, (8, 8)),      # causal T_q < T_kv, aligned top-left
    (40, 16, (8, 8)),      # causal T_q > T_kv
])
def test_ragged_and_cross_length_match_the_op(t_q, t_kv, blocks):
    q, k, v, do = _inputs(3, (2, 2, t_q, 16), (2, 2, t_kv, 16))
    want_out, want = _jax_grads(
        lambda a, b, c: pk.flash_attention(a, b, c, causal=True,
                                           block_q=blocks[0],
                                           block_k=blocks[1]),
        q, k, v, do)
    got_out, got = _port_grads(q, k, v, do, causal=True)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-4, atol=2e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t_q,t_kv,causal", [
    (127, 127, False), (127, 127, True),
    (129, 129, False), (129, 129, True),
    (255, 255, False), (255, 255, True),
    (257, 257, False), (257, 257, True),
    (129, 300, True), (300, 129, True), (1, 128, True), (128, 1, True),
])
def test_tile_edges_match_pallas_kernels(t_q, t_kv, causal):
    """The lengths around the card kernels' 64- and 128-row tile edges,
    and causal cross lengths, at small BH and D: the port's plain K1-K3
    (what the card holds its kernels against) against the JAX package's
    Pallas kernels in the interpreter, each axis one block (the lengths
    do not tile).  f32, tolerance 2e-4 as above."""
    q, k, v, do = _inputs(6, (2, t_q, 16), (2, t_kv, 16))
    scale = 1.0 / np.sqrt(16)
    want_out, want = _jax_grads(
        lambda a, b, c: pk._flash_attention(a, b, c, scale, causal, t_q,
                                            t_kv),
        q, k, v, do)
    got_out, got = _port_grads(q, k, v, do, scale=scale, causal=causal)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-4, atol=2e-4)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg="d%s (t_q=%d t_kv=%d causal=%s)"
                                   % (name, t_q, t_kv, causal))


def test_op_contract_shapes_and_scale():
    q, k, v, _ = _inputs(4, (2, 3, 16, 8), (2, 3, 16, 8))
    want4 = np.asarray(pk.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          scale=0, causal=True))
    got4 = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0,
                              causal=True)
    assert got4.shape == (2, 3, 16, 8)
    np.testing.assert_allclose(got4.numpy(), want4, rtol=2e-4, atol=2e-4)
    # (BH, T, D) inputs give (BH, T, D)
    q3, k3, v3 = (a.reshape(6, 16, 8) for a in (q, k, v))
    want3 = np.asarray(pk.flash_attention(*map(jnp.asarray, (q3, k3, v3)),
                                          scale=0.3))
    got3 = fa.flash_attention(*map(torch.from_numpy, (q3, k3, v3)),
                              scale=0.3)
    assert got3.shape == (6, 16, 8)
    np.testing.assert_allclose(got3.numpy(), want3, rtol=2e-4, atol=2e-4)
    with pytest.raises(MXNetError, match="do not match"):
        fa.flash_attention(torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 4),
                           torch.zeros(1, 2, 4, 4))


def test_cpu_path_launches_no_kernel_and_keeps_no_quadratic_residual():
    q, k, v, do = _inputs(5, (1, 2, 32, 8), (1, 2, 32, 8))
    before = (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    qt = torch.from_numpy(q).requires_grad_()
    out = fa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                             causal=True)
    # the Function's residuals are (q, k, v, out, lse): none is (T, T)
    node = out.grad_fn
    while "Flash" not in type(node).__name__:
        node = node.next_functions[0][0]
    saved = node.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(2, 32, 8)] * 4 + [(2, 32)]
    out.backward(torch.from_numpy(do))
    assert (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches) == before


def test_kernel_source_and_build_location():
    import os

    from mxnet_tpu_torch.ops import _build

    assert os.path.isfile(fa._SOURCE)
    assert fa._SOURCE.endswith(os.path.join("csrc", "flash_attention.cu"))
    assert fa.library_path().startswith(_build.BUILD_DIR)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with open(fa._SOURCE) as f:
        src = f.read()
    for name in ("_flash_fwd_kernel", "_flash_bwd_dq_kernel",
                 "_flash_bwd_dkv_kernel"):
        assert name in src
