"""``mx.rtc`` (K5) and the imperative slice as a whole, on the host.

* ``PallasKernel`` — the plain version of K5 — against the JAX package's
  on the same seeded inputs, both interpreted: the ``scale_add`` body of
  ``tests/test_pallas.py``, a ``grid``/``BlockSpec`` case, ``program_id``,
  backward raising in both packages, ``PallasModule.get_kernel``.
  Outputs are compared exactly: the bodies do the same f32 arithmetic.
* What of ``CudaKernel`` needs no card: MXNet 1.x's signature parser and
  the ``void*[]`` argument array; and what must raise here (``CudaModule``
  without CUDA, a Python body given arrays off the host).
* The slice: ``chip_smoke.mlp_step`` — the imperative MLP step the smoke
  runs on the card, with SwiGLU as an ``autograd.Function`` over
  ``PallasKernel`` bodies — in both packages from the same seeded f32
  weights: loss, gradients and updated weights agree to 1e-5 of each
  tensor's largest value (XLA:CPU and ATen sum the products in another
  order).
"""
import ctypes

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError


def scale_add(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0 + y_ref[...]


def _inputs(seed=4, shape=(8, 128)):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def test_scale_add_matches_jax_exactly():
    x, y = _inputs()
    jk = jmx.rtc.PallasKernel(
        scale_add, out_shape=jax.ShapeDtypeStruct((8, 128), np.float32))
    want = jk(jmx.nd.array(x), jmx.nd.array(y)).asnumpy()
    tk = rtc.PallasKernel(scale_add,
                          out_shape=rtc.ShapeDtypeStruct((8, 128),
                                                         np.float32))
    with tmx.cpu():
        out = tk(tmx.nd.array(x), tmx.nd.array(y))
    assert out.context == tmx.cpu() and out.shape == (8, 128)
    np.testing.assert_array_equal(out.asnumpy(), want)
    np.testing.assert_array_equal(out.asnumpy(), x * 2 + y)
    # jax's own ShapeDtypeStruct serves the port too
    tk2 = rtc.PallasKernel(scale_add,
                           out_shape=jax.ShapeDtypeStruct((8, 128),
                                                          np.float32))
    with tmx.cpu():
        np.testing.assert_array_equal(
            tk2(tmx.nd.array(x), tmx.nd.array(y)).asnumpy(), want)


def _grid_body(pid):
    def body(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + y_ref[...] + pid(0) * 10.0 \
            + pid(1)
    return body


def test_grid_blockspec_matches_jax_exactly():
    x, y = _inputs(5, (8, 256))
    out_shape = (8, 256)
    jspec = pl.BlockSpec((4, 64), lambda i, j: (i, j))
    jk = jmx.rtc.PallasKernel(
        _grid_body(pl.program_id),
        out_shape=jax.ShapeDtypeStruct(out_shape, np.float32),
        in_specs=[jspec, jspec], out_specs=jspec, grid=(2, 4))
    want = jk(jmx.nd.array(x), jmx.nd.array(y)).asnumpy()
    tspec = rtc.BlockSpec((4, 64), lambda i, j: (i, j))
    tk = rtc.PallasKernel(
        _grid_body(rtc.program_id),
        out_shape=rtc.ShapeDtypeStruct(out_shape, np.float32),
        in_specs=[tspec, tspec], out_specs=tspec, grid=(2, 4))
    with tmx.cpu():
        got = tk(tmx.nd.array(x), tmx.nd.array(y)).asnumpy()
    np.testing.assert_array_equal(got, want)
    # each block saw its own grid position
    assert got[4, 64] == x[4, 64] * 2 + y[4, 64] + 11.0


def test_squeezed_block_axis_and_two_outputs():
    x, _ = _inputs(6, (3, 4, 8))

    def body(x_ref, s_ref, m_ref):
        s_ref[...] = x_ref[...].sum(-1, keepdims=True)
        m_ref[...] = x_ref[...] * rtc.num_programs(0)

    spec = rtc.BlockSpec((None, 4, 8), lambda i: (i, 0, 0))
    ospec = [rtc.BlockSpec((None, 4, 1), lambda i: (i, 0, 0)), spec]
    k = rtc.PallasKernel(body, out_shape=(
        rtc.ShapeDtypeStruct((3, 4, 1), np.float32),
        rtc.ShapeDtypeStruct((3, 4, 8), np.float32)),
        in_specs=[spec], out_specs=ospec, grid=3)
    with tmx.cpu():
        s, m = k(tmx.nd.array(x))
    np.testing.assert_allclose(s.asnumpy(), x.sum(-1, keepdims=True),
                               rtol=1e-6)
    np.testing.assert_array_equal(m.asnumpy(), x * 3)


def test_backward_through_a_pallas_kernel_raises_in_both_packages():
    x, y = _inputs()
    jk = jmx.rtc.PallasKernel(
        scale_add, out_shape=jax.ShapeDtypeStruct((8, 128), np.float32))
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jmx.autograd.record():
        jl = jk(jx, jmx.nd.array(y)).sum()
    with pytest.raises(ValueError, match="Linearization"):
        jl.backward()
    tk = rtc.PallasKernel(scale_add, out_shape=rtc.ShapeDtypeStruct(
        (8, 128), np.float32))
    with tmx.cpu():
        tx = tmx.nd.array(x)
        tx.attach_grad()
        with tmx.autograd.record():
            out = tk(tx, tmx.nd.array(y))
            tl = out.sum()
        assert out._in_graph          # recorded, as in the JAX package
        with pytest.raises(MXNetError, match="'scale_add' has no gradient"):
            tl.backward()


def test_pallas_module_get_kernel_in_both_packages():
    jk = jmx.rtc.PallasKernel(
        scale_add, out_shape=jax.ShapeDtypeStruct((8, 128), np.float32))
    tk = rtc.PallasKernel(scale_add, out_shape=rtc.ShapeDtypeStruct(
        (8, 128), np.float32))
    for mod, k, err in ((jmx.rtc.PallasModule(scale_add=jk), jk,
                         jmx.MXNetError),
                        (rtc.PallasModule(scale_add=tk), tk, MXNetError)):
        assert mod.get_kernel("scale_add") is k
        assert mod.get_kernel("scale_add", "ignored signature") is k
        with pytest.raises(err, match="no kernel"):
            mod.get_kernel("missing")


def test_what_raises_without_a_card():
    x, y = _inputs()
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="needs CUDA"):
            rtc.CudaModule('extern "C" __global__ void k() {}')
        with pytest.raises(MXNetError, match="needs CUDA"):
            chip_smoke.SwigluKernels(tmx).kernel("fwd", torch.float32)
    # a Python body given arrays off the host, without interpret=True
    k = rtc.PallasKernel(scale_add, out_shape=rtc.ShapeDtypeStruct(
        (8, 128), np.float32))
    with tmx.cpu():
        off = tmx.nd.array(x)
    off._data = torch.empty((8, 128), device="meta")
    with pytest.raises(MXNetError, match="interpret=True"):
        k(off, off)
    with pytest.raises(MXNetError, match="not supported"):
        rtc.PallasKernel(scale_add, out_shape=None, compiler_params={})
    with pytest.raises(MXNetError, match="no compiled form"):
        rtc.PallasKernel(scale_add, out_shape=None, interpret=False)
    # explicit interpret=True runs the body wherever the arrays are
    k2 = rtc.PallasKernel(scale_add, out_shape=rtc.ShapeDtypeStruct(
        (8, 128), np.float32), interpret=True)
    with tmx.cpu():
        np.testing.assert_array_equal(
            k2(tmx.nd.array(x), tmx.nd.array(y)).asnumpy(), x * 2 + y)


@pytest.mark.parametrize("signature,want", [
    ("const float *x, const float *y, float *out, int n",
     [("x", "float", True, True), ("y", "float", True, True),
      ("out", "float", True, False), ("n", "int", False, False)]),
    ("const __nv_bfloat16 *__restrict__ a, __nv_bfloat16* h, long long n",
     [("a", "__nv_bfloat16", True, True), ("h", "__nv_bfloat16", True, False),
      ("n", "long long", False, False)]),
    ("double *p,unsigned int k,unsigned u,float f,double d,bool flag,"
     "const int64_t*idx, uint8_t *m, const void *raw",
     [("p", "double", True, False), ("k", "unsigned int", False, False),
      ("u", "unsigned", False, False), ("f", "float", False, False),
      ("d", "double", False, False), ("flag", "bool", False, False),
      ("idx", "int64_t", True, True), ("m", "uint8_t", True, False),
      ("raw", "void", True, True)]),
    ("float *, int", [("arg0", "float", True, False),
                      ("arg1", "int", False, False)]),
])
def test_signature_parser(signature, want):
    got = [(a.name, a.ctype, a.pointer, a.const)
           for a in rtc.parse_signature(signature)]
    assert got == want


@pytest.mark.parametrize("signature,match", [
    ("float **x", "pointer to a pointer"),
    ("float3 *v", "does not launch with"),
    ("half h", "does not launch with"),
    ("float x[4]", "cannot parse"),
])
def test_signature_parser_refuses(signature, match):
    with pytest.raises(MXNetError, match=match):
        rtc.parse_signature(signature)


def test_argument_array_points_at_each_argument():
    k = rtc.CudaKernel(None, "k", "k", "const float *x, __nv_bfloat16 *h, "
                       "long long n, float s, unsigned u, bool b")
    with tmx.cpu():
        x = tmx.nd.array(np.arange(4, dtype=np.float32))
        h = tmx.nd.zeros((4,), dtype="bfloat16")
        dev = torch.device("cpu")
        params, keep, reads, writes = k.pack([x, h, 2 ** 40 + 3, 0.5, 7,
                                              True], dev)
    assert reads == [x] and writes == [h]
    addr = [params[i] for i in range(6)]
    assert addr == [ctypes.addressof(v) for v in keep]
    assert ctypes.c_void_p.from_address(addr[0]).value == x._data.data_ptr()
    assert ctypes.c_void_p.from_address(addr[1]).value == h._data.data_ptr()
    assert ctypes.c_int64.from_address(addr[2]).value == 2 ** 40 + 3
    assert ctypes.c_float.from_address(addr[3]).value == 0.5
    assert ctypes.c_uint32.from_address(addr[4]).value == 7
    assert ctypes.c_bool.from_address(addr[5]).value is True
    with tmx.cpu():
        with pytest.raises(MXNetError, match="needs torch.float32"):
            k.pack([h, h, 1, 1.0, 1, True], dev)
        with pytest.raises(MXNetError, match="takes 6 arguments"):
            k.pack([x, h], dev)
        with pytest.raises(MXNetError, match="is a scalar"):
            k.pack([x, h, x, 1.0, 1, True], dev)
        with pytest.raises(MXNetError, match="contiguous"):
            k.pack([tmx.nd.array(np.zeros((4, 2), np.float32)).T, h, 1, 1.0,
                    1, True], dev)
        with pytest.raises(MXNetError, match="on cpu, the launch on meta"):
            k.pack([x, h, 1, 1.0, 1, True], torch.device("meta"))
        # writing in place into an array a recorded graph computed
        w = tmx.nd.array(np.ones(4, np.float32))
        w.attach_grad()
        with tmx.autograd.record():
            hw = (w * 2).astype("bfloat16")
        with pytest.raises(MXNetError, match="recorded graph"):
            k.pack([x, hw, 1, 1.0, 1, True], dev)
    with pytest.raises(MXNetError, match="gpu context"):
        k.launch([x, h, 1, 1.0, 1, True], tmx.cpu(), (1,), (1,))
    for dims in ((), (0,), (1, 1, 1, 1)):
        with pytest.raises(MXNetError, match="grid_dims"):
            rtc._dims(dims, "grid_dims")


def test_compile_options_use_the_cuda_home(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/opt/cuda-x")
    opts = rtc.compile_options(("-DFOO=1",))
    assert opts == ["--gpu-architecture=sm_90a", "-std=c++17",
                    "--include-path=/opt/cuda-x/include", "-DFOO=1"]


# -- the slice: the imperative MLP step in both packages --------------------

class JaxSwiglu:
    """The JAX package's SwiGLU user kernels: Pallas bodies in jnp."""

    def fwd(self, a, b):
        def body(a_ref, b_ref, h_ref):
            x = a_ref[...]
            h_ref[...] = x * jax.nn.sigmoid(x) * b_ref[...]

        return jmx.rtc.PallasKernel(body, out_shape=jax.ShapeDtypeStruct(
            a.shape, a.dtype), name="swiglu_fwd")(a, b)

    def bwd(self, a, b, dh):
        def body(a_ref, b_ref, dh_ref, da_ref, db_ref):
            x, y, g = a_ref[...], b_ref[...], dh_ref[...]
            s = jax.nn.sigmoid(x)
            gs = g * s
            da_ref[...] = gs * y * (1 + x * (1 - s))
            db_ref[...] = gs * x

        spec = jax.ShapeDtypeStruct(a.shape, a.dtype)
        return jmx.rtc.PallasKernel(body, out_shape=(spec, spec),
                                    name="swiglu_bwd")(a, b, dh)


def _run_steps(mx, kernels, arrays, n_steps, ctx=None):
    SwiGLU = chip_smoke.swiglu_function(mx, kernels)
    params, x, target = chip_smoke.mlp_arrays(mx, arrays, ctx)
    losses = []
    for _ in range(n_steps):
        loss = chip_smoke.mlp_step(mx, params, x, target,
                                   lambda a, b: SwiGLU()(a, b), 0.5)
        losses.append(float(loss.asscalar()))
    return losses, [w.grad.asnumpy() for w in params], \
        [w.asnumpy() for w in params]


def _close(got, want, rel):
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


def test_imperative_mlp_step_matches_jax():
    arrays = chip_smoke.mlp_numpy(32, 64, 16, seed=3)
    jl, jg, jw = _run_steps(jmx, JaxSwiglu(), arrays, 3)
    with tmx.cpu():
        kern = chip_smoke.SwigluKernels(tmx)
        tl, tg, tw = _run_steps(tmx, kern, arrays, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _close(tg, jg, 1e-5)
    _close(tw, jw, 1e-5)


def test_swiglu_function_gradients_match_closed_form():
    rs = np.random.RandomState(7)
    a_np, b_np, g_np = (rs.randn(5, 6).astype(np.float32) for _ in range(3))
    with tmx.cpu():
        a, b = tmx.nd.array(a_np), tmx.nd.array(b_np)
        a.attach_grad()
        b.attach_grad()
        SwiGLU = chip_smoke.swiglu_function(
            tmx, chip_smoke.SwigluKernels(tmx))
        with tmx.autograd.record():
            h = SwiGLU()(a, b)
        h.backward(tmx.nd.array(g_np))
    s = 1 / (1 + np.exp(-a_np.astype(np.float64)))
    np.testing.assert_allclose(h.asnumpy(), a_np * s * b_np, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(a.grad.asnumpy(),
                               g_np * b_np * s * (1 + a_np * (1 - s)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.grad.asnumpy(), g_np * a_np * s,
                               rtol=1e-5, atol=1e-6)


def test_bf16_ulp_distance():
    vals = torch.tensor([1.0, -1.0, 0.0, 3.0], dtype=torch.bfloat16)
    one_up = torch.tensor([1.0078125, -0.99609375, 0.0, 3.015625],
                          dtype=torch.bfloat16)
    assert chip_smoke.bf16_ulps(vals, vals).max().item() == 0
    assert chip_smoke.bf16_ulps(one_up, vals).tolist() == [1, 1, 0, 1]
    # +0 and -0 are the same value
    assert chip_smoke.bf16_ulps(torch.tensor([-0.0], dtype=torch.bfloat16),
                                torch.tensor([0.0], dtype=torch.bfloat16)
                                ).item() == 0
