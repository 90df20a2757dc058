"""The port's ``ops/quantized_ops.py`` (and O5's and O6's plain versions,
``ops/int8_ops.py``) against the JAX package's ``ops/quantized_ops.py``,
on the CPU.

The same seeded numpy inputs go through both packages' registered
forwards.  int8, uint8 and int32 outputs must be bitwise equal; f32
outputs and ranges within 1 f32 ulp (both packages round each f32
operation once, in the same order; 1 ulp admits XLA's CPU code fusing a
multiply and an add); ``_contrib_calibrate_entropy``'s threshold within
1e-5 relative (its 64 KL sums are reduced in another order, which can
move a sum by ulps but not the chosen candidate).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ndarray  # noqa: F401  (registers every JAX op)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import int8_ops
from mxnet_tpu_torch.ops import registry as treg


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0, scale=1.0):
    return (_rs(seed).standard_normal(shape) * scale).astype(np.float32)


def _i8(*shape, seed=0):
    return _rs(seed).randint(-127, 128, shape).astype(np.int8)


def _s(v):
    return np.asarray(v, np.float32)


def _same(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def check_quantized(name, inputs, attrs=None):
    """Every output of the port's op against the JAX op's (dtype, shape,
    value: integers bitwise, f32 within 1 ulp)."""
    attrs = attrs or {}
    want = jreg.get(name).forward(*[jnp.asarray(a) for a in inputs],
                                  **attrs)
    got = treg.get(name).forward(*[torch.from_numpy(np.array(a))
                                   for a in inputs], **attrs)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, "%s output %d" % (name, i))
    return got


# -- quantize_v2, requantize ---------------------------------------------------


@pytest.mark.parametrize("calib", [False, True])
@pytest.mark.parametrize("out_type", ["int8", "uint8"])
def test_quantize_v2_matches_jax(out_type, calib):
    x = _f32(4, 5, 6, seed=1, scale=2.0)
    x[0, 0, :3] = [0.5, -0.5, 1.5]     # ties of round half to even
    attrs = {"out_type": out_type}
    if calib:
        attrs.update(min_calib_range=-1.7, max_calib_range=2.3)
    check_quantized("_contrib_quantize_v2", [x], attrs)


@pytest.mark.parametrize("calib", [False, True])
def test_requantize_matches_jax(calib):
    acc = _rs(2).randint(-2 ** 24, 2 ** 24, (6, 7)).astype(np.int32)
    attrs = {"min_calib_range": -0.8, "max_calib_range": 0.6} if calib \
        else {}
    check_quantized("_contrib_requantize", [acc, _s(-3.5), _s(2.5)], attrs)


@pytest.mark.parametrize("out_type", ["uint8", "int8"])
def test_contrib_quantize_and_dequantize_divide_as_jax(out_type):
    """``_contrib_quantize``'s ``(qmax - qmin) / range`` and
    ``_contrib_dequantize``'s ``range / (qmax - qmin)`` are true f32
    divisions, as in the JAX package: at a range of 3.5, whose quotients
    are not the products by the reciprocals, a dense grid of values
    rounds bitwise as the JAX op's."""
    lo, hi = _s([-1.2]), _s([2.3])
    x = np.linspace(-1.3, 2.4, 40001, dtype=np.float32)
    q = check_quantized("_contrib_quantize", [x, lo, hi],
                        {"out_type": out_type})[0]
    check_quantized("_contrib_dequantize", [q.numpy(), lo, hi])


# -- the contractions: O5 and O6 through the registered ops ------------------------


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_quantized_fully_connected_matches_jax(with_bias, flatten):
    data = _i8(3, 4, 40, seed=3)
    weight = _i8(17, 160 if flatten else 40, seed=4)
    ranges = [_s(-1.2), _s(0.9), _s(-0.4), _s(0.35)]
    if with_bias:
        inputs = [data, weight, _i8(17, seed=5)] + ranges \
            + [_s(-0.02), _s(0.03)]
    else:
        inputs = [data, weight, None] + ranges
    attrs = {"num_hidden": 17, "no_bias": not with_bias, "flatten": flatten}
    want = jreg.get("_contrib_quantized_fully_connected").forward(
        *[None if a is None else jnp.asarray(a) for a in inputs], **attrs)
    got = treg.get("_contrib_quantized_fully_connected").forward(
        *[None if a is None else torch.from_numpy(a) for a in inputs],
        **attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, "fc output %d" % i)
    assert got[0].dtype == torch.int32


_CONV_CASES = {
    "stride2-pad1": dict(shape=(2, 8, 9, 9), filters=6, kernel=(3, 3),
                         stride=(2, 2), pad=(1, 1), dilate=(1, 1), group=1),
    "dilate2-pad2": dict(shape=(2, 5, 11, 10), filters=4, kernel=(3, 3),
                         stride=(1, 1), pad=(2, 2), dilate=(2, 2), group=1),
    "groups2": dict(shape=(1, 6, 7, 8), filters=4, kernel=(3, 2),
                    stride=(1, 2), pad=(1, 0), dilate=(1, 1), group=2),
    "depthwise": dict(shape=(2, 4, 6, 6), filters=4, kernel=(3, 3),
                      stride=(1, 1), pad=(1, 1), dilate=(1, 1), group=4),
    "stem-7x7": dict(shape=(1, 3, 20, 20), filters=8, kernel=(7, 7),
                     stride=(2, 2), pad=(3, 3), dilate=(1, 1), group=1),
}


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_quantized_conv_matches_jax(case, with_bias):
    c = _CONV_CASES[case]
    n, ch = c["shape"][:2]
    data = _i8(*c["shape"], seed=6)
    weight = _i8(c["filters"], ch // c["group"], *c["kernel"], seed=7)
    ranges = [_s(-2.0), _s(1.5), _s(-0.3), _s(0.25)]
    bias = _i8(c["filters"], seed=8) if with_bias else None
    inputs = [data, weight, bias] + ranges + (
        [_s(-0.01), _s(0.02)] if with_bias else [])
    attrs = {"kernel": c["kernel"], "stride": c["stride"], "pad": c["pad"],
             "dilate": c["dilate"], "num_filter": c["filters"],
             "num_group": c["group"], "no_bias": not with_bias}
    want = jreg.get("_contrib_quantized_conv").forward(
        *[None if a is None else jnp.asarray(a) for a in inputs], **attrs)
    got = treg.get("_contrib_quantized_conv").forward(
        *[None if a is None else torch.from_numpy(a) for a in inputs],
        **attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, "conv %s output %d" % (case, i))


# -- the elementwise ops ----------------------------------------------------------


@pytest.mark.parametrize("pool", [
    dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(pool_type="avg", kernel=(2, 2), stride=(2, 2)),
    dict(pool_type="avg", kernel=(3, 3), stride=(1, 1), pad=(1, 1),
         pooling_convention="full"),
    dict(pool_type="max", global_pool=True)], ids=["max", "avg", "avg-full",
                                                     "global-max"])
def test_quantized_pooling_matches_jax(pool):
    check_quantized("_contrib_quantized_pooling",
                    [_i8(2, 3, 8, 8, seed=9), _s(-1.0), _s(1.0)], pool)


def test_quantized_relu_matches_jax_and_other_acts_raise():
    check_quantized("_contrib_quantized_act",
                    [_i8(3, 4, 5, seed=10), _s(-0.7), _s(0.9)],
                    {"act_type": "relu"})
    for pkg in (jreg, treg):
        with pytest.raises(NotImplementedError, match="relu"):
            pkg.get("_contrib_quantized_act").forward(
                *[np.zeros(2, np.int8), _s(-1), _s(1)]
                if pkg is jreg else [torch.zeros(2, dtype=torch.int8),
                                     torch.tensor(-1.0), torch.tensor(1.0)],
                act_type="tanh")


def test_quantized_flatten_matches_jax():
    check_quantized("_contrib_quantized_flatten",
                    [_i8(2, 3, 4, 5, seed=11), _s(-0.5), _s(0.5)])


@pytest.mark.parametrize("lhs_type", ["int8", "uint8"])
def test_quantized_elemwise_add_matches_jax(lhs_type):
    lhs = _i8(4, 6, seed=12) if lhs_type == "int8" \
        else _rs(12).randint(0, 256, (4, 6)).astype(np.uint8)
    check_quantized("_contrib_quantized_elemwise_add",
                    [lhs, _i8(4, 6, seed=13), _s(-0.6), _s(1.1), _s(-2.0),
                     _s(1.7)])


def test_quantized_elemwise_mul_matches_jax():
    check_quantized("_contrib_quantized_elemwise_mul",
                    [_i8(5, 3, seed=14), _i8(5, 3, seed=15), _s(-0.6),
                     _s(1.1), _s(-2.0), _s(1.7)])


def test_quantized_concat_of_three_matches_jax():
    qs = [_i8(2, c, 3, seed=16 + c) for c in (2, 3, 4)]
    mins = [_s(-0.5), _s(-1.5), _s(-0.25)]
    maxs = [_s(0.75), _s(1.0), _s(2.5)]
    check_quantized("_contrib_quantized_concat", qs + mins + maxs,
                    {"num_args": 3, "dim": 1})


def test_quantized_embedding_clips_ids_as_jax():
    ids = np.array([[0, 3, 9], [-2, 12, 5.7]], np.float32)   # 10-row table
    check_quantized("_contrib_quantized_embedding",
                    [ids, _i8(10, 4, seed=19), _s(-0.3), _s(0.4)],
                    {"input_dim": 10, "output_dim": 4})


@pytest.mark.parametrize("calib", [False, True])
def test_quantized_batch_norm_matches_jax(calib):
    rs = _rs(20)
    inputs = [_i8(2, 5, 4, 4, seed=21),
              rs.uniform(0.5, 1.5, 5).astype(np.float32),
              rs.uniform(-0.2, 0.2, 5).astype(np.float32),
              rs.uniform(-0.1, 0.1, 5).astype(np.float32),
              rs.uniform(0.5, 2.0, 5).astype(np.float32),
              _s(-1.3), _s(0.8)]
    attrs = {"eps": 1e-3, "fix_gamma": False}
    if calib:
        attrs.update(min_calib_range=-2.5, max_calib_range=2.0)
    check_quantized("_contrib_quantized_batch_norm", inputs, attrs)


@pytest.mark.parametrize("seed", [22, 23])
def test_calibrate_entropy_matches_jax(seed):
    rs = _rs(seed)
    vals = np.abs(np.concatenate([rs.standard_normal(20000),
                                  rs.standard_normal(200) * 6]))
    hist, edges = np.histogram(vals, bins=512, range=(0, vals.max()))
    hist, edges = hist.astype(np.float32), edges.astype(np.float32)
    want = jreg.get("_contrib_calibrate_entropy").forward(
        jnp.asarray(hist), jnp.asarray(edges))
    got = treg.get("_contrib_calibrate_entropy").forward(
        torch.from_numpy(hist), torch.from_numpy(edges))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    assert float(got[1]) < float(edges[-1])     # a cut, not the max


# -- through mx.nd.contrib, as the JAX package reaches them ----------------------


def test_nd_contrib_reaches_the_quantized_ops_as_in_jax():
    x = _f32(3, 4, seed=24)
    want = jmx.nd.contrib.quantize_v2(jmx.nd.array(x), out_type="int8")
    got = tmx.nd.contrib.quantize_v2(tmx.nd.array(x, ctx=tmx.cpu()),
                                     out_type="int8")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g.asnumpy(), w.asnumpy(), "nd.contrib.quantize_v2")
    names = {"quantize_v2", "requantize", "quantized_conv",
             "quantized_fully_connected", "quantized_pooling",
             "quantized_act", "quantized_flatten", "quantized_elemwise_add",
             "quantized_elemwise_mul", "quantized_concat",
             "quantized_embedding", "quantized_batch_norm",
             "calibrate_entropy"}
    assert names <= set(dir(tmx.nd.contrib))
    assert names <= set(dir(jmx.nd.contrib))


# -- O5's and O6's plain versions -------------------------------------------------


def test_int8_plain_versions_are_exact_at_the_largest_sums():
    """float64 holds every int8 x int8 sum at ResNet-50's K of 4,608
    exactly: all-127 operands give 127 * 127 * K, and the f32 epilogue
    divides that once."""
    k = 4608
    a = torch.full((3, k), 127, dtype=torch.int8)
    b = torch.full((2, k), -127, dtype=torch.int8)
    acc = int8_ops.int8_gemm(a, b)
    assert acc.dtype == torch.int32
    assert (acc == -127 * 127 * k).all()
    x = torch.full((1, 3, 3, 512), 127, dtype=torch.int8)
    w = torch.full((4, 3, 3, 512), 127, dtype=torch.int8)
    out = int8_ops.int8_conv(x, w, denom=3.0,
                             bias=torch.ones(4, dtype=torch.float32))
    want = np.float32(127 * 127 * k) / np.float32(3.0) + np.float32(1)
    assert out.shape == (1, 1, 1, 4) and (out.numpy() == want).all()


def test_int8_conv_plain_version_matches_jax_conv():
    """O6's plain version (channels last) against the JAX package's
    ``conv_general_dilated`` with int32 accumulation, through the
    layouts: stride, padding, dilation and groups."""
    import jax

    x = _i8(2, 9, 11, 6, seed=25)                 # NHWC
    w = _i8(8, 3, 2, 3, seed=26)                  # OHWI, 2 groups
    got = int8_ops.int8_conv(torch.from_numpy(x), torch.from_numpy(w),
                             (2, 1), (1, 1), (1, 2), 2)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 1), [(1, 1), (1, 1)],
        rhs_dilation=(1, 2), feature_group_count=2,
        dimension_numbers=("NHWC", "OHWI", "NHWC"),
        preferred_element_type=jnp.int32)
    _same(got, want, "int8_conv")


def test_int8_wrappers_refuse_what_the_kernels_do_not_take():
    from mxnet_tpu_torch.base import MXNetError

    a = torch.zeros(2, 8, dtype=torch.int8)
    with pytest.raises(MXNetError, match="int8"):
        int8_ops.int8_gemm(a.float(), a)
    with pytest.raises(MXNetError, match="K differs"):
        int8_ops.int8_gemm(a, torch.zeros(3, 7, dtype=torch.int8))
    with pytest.raises(MXNetError, match="bias"):
        int8_ops.int8_gemm(a, a, bias=torch.zeros(2), denom=None)
    x = torch.zeros(1, 4, 4, 6, dtype=torch.int8)
    with pytest.raises(MXNetError, match="groups"):
        int8_ops.int8_conv(x, torch.zeros(4, 3, 3, 4, dtype=torch.int8),
                           num_group=2)
    with pytest.raises(MXNetError, match="no output"):
        int8_ops.int8_conv(x, torch.zeros(4, 5, 5, 6, dtype=torch.int8))
