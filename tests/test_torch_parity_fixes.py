"""Faults F8-F13 of the port, each held against the JAX package on the
CPU: user-written ``Block.forward`` on ``mx.nd`` and the parameter
attributes' ``data()``/``grad()``/``set_data()`` (F8), negative-step
slices (F9), the dtypes of integer and boolean reductions (F10), slicing
``Sequential`` and ``HybridSequential`` (F11), the public names of the
done modules (F12), and the scalar divisions (F13), which the JAX
package computes as true f32 divisions, bitwise.

Inputs are made by numpy from a seed; the port's weights are the JAX
package's, saved by ``save_parameters`` and read by the port's
``load_parameters``.  Outputs are held within rtol 1e-6 / atol 1e-6 of
the JAX package's, gradients within rtol 1e-5 / atol 1e-6 (f32, the same
formulas, op by op); indexing, dtypes and integer reductions exactly.
"""
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import NDArray

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)


# -- F8: user-written forward and the parameter attributes -----------------


def _blocks(mx):
    """The blocks of F8's report, written once over either package:
    ``examples/autoencoder/train_vae.py``'s ``VAE`` at small widths, and
    a block with a ``params.get`` parameter read through ``.data()``."""
    gluon, nd, nn = mx.gluon, mx.nd, mx.gluon.nn

    class VAE(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.enc = nn.HybridSequential()
                self.enc.add(nn.Dense(8, activation="relu"))
                self.mu = nn.Dense(2)
                self.logvar = nn.Dense(2)
                self.dec = nn.HybridSequential()
                self.dec.add(nn.Dense(8, activation="relu"), nn.Dense(6))

        def forward(self, x):
            h = self.enc(x)
            mu, logvar = self.mu(h), self.logvar(h)
            # reparameterization: z = mu + sigma * eps, eps ~ N(0, 1)
            eps = nd.random.normal(0, 1, shape=mu.shape)
            z = mu + (0.5 * logvar).exp() * eps
            return self.dec(z), mu, logvar

    class Scaled(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc = nn.Dense(3, in_units=2)
                self.scale = self.params.get("scale", shape=(3,))

        def forward(self, x):
            return nd.relu(self.fc(x)) * self.scale.data()

    return VAE, Scaled


JVAE, JSCALED = _blocks(jmx)
TVAE, TSCALED = _blocks(tmx)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def _pair(jcls, tcls, x, tmp_path, seed=0):
    """The JAX block, initialized from ``seed`` and run once on ``x``,
    and the port's (on the host) with its weights read from the JAX
    block's ``.params`` file."""
    jmx.random.seed(seed)
    jnet = jcls()
    jnet.initialize(jmx.init.Uniform(0.7))
    jnet(jmx.nd.array(x))
    path = str(tmp_path / "net.params")
    jnet.save_parameters(path)
    with tmx.cpu():
        net = tcls()
        net.initialize()
        net(tmx.nd.array(x))
        net.load_parameters(path)
    return jnet, net


def _fixed_noise(monkeypatch, eps):
    """``nd.random.normal`` of both packages giving ``eps``: the two RNGs
    differ, so the noise is made by numpy and handed to both."""
    for mx in (jmx, tmx):
        monkeypatch.setattr(
            mx.nd.random, "normal",
            lambda loc=0, scale=1, shape=None, mx=mx, **kw:
            mx.nd.array(eps))


def _vae_loss(mx, net, x):
    """The example's loss: sigmoid cross entropy plus the KL term."""
    bce = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=False)
    logits, mu, logvar = net(x)
    recon = bce(logits, x).sum(axis=-1).mean()
    kl = (-0.5 * (1 + logvar - mu ** 2 - logvar.exp())).sum(axis=-1).mean()
    return (logits, mu, logvar), recon + kl


def test_vae_forward_of_the_example_matches_jax(monkeypatch, tmp_path):
    """F8 case 1: the example's ``VAE.forward`` (``nd.random.normal``,
    NDArray arithmetic on child outputs) under ``record()`` gives the JAX
    package's outputs, loss and gradients."""
    x = (np.random.RandomState(1).uniform(size=(4, 6)) > 0.5) \
        .astype(np.float32)
    jnet, net = _pair(JVAE, TVAE, x, tmp_path)
    _fixed_noise(monkeypatch, _x(4, 2, seed=2))
    with jmx.autograd.record():
        jouts, jloss = _vae_loss(jmx, jnet, jmx.nd.array(x))
    jloss.backward()
    with tmx.cpu(), tmx.autograd.record():
        outs, loss = _vae_loss(tmx, net, tmx.nd.array(x))
    loss.backward()
    for got, want in zip(outs, jouts):
        assert isinstance(got, NDArray)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    np.testing.assert_allclose(loss.asnumpy(), jloss.asnumpy(), **TOL)
    jparams = jnet._collect_params_with_prefix()
    tparams = net._param_handles()
    assert sorted(jparams) == sorted(tparams)
    for name, p in jparams.items():
        np.testing.assert_allclose(tparams[name].grad().asnumpy(),
                                   p.grad().asnumpy(), **GRAD)


def test_vae_forward_draws_its_noise_on_the_port():
    """The example's forward as written, noise from the port's own
    generator: (4, 2) latents, finite outputs, every parameter reached by
    the gradient."""
    with tmx.cpu():
        tmx.random.seed(3)
        net = TVAE()
        net.initialize(tmx.init.Xavier())
        with tmx.autograd.record():
            (logits, mu, _), loss = _vae_loss(tmx, net, tmx.nd.ones((4, 6)))
        loss.backward()
    assert logits.shape == (4, 6) and mu.shape == (4, 2)
    assert np.isfinite(logits.asnumpy()).all()
    for p in net.collect_params().values():
        g = p.grad().asnumpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0, p.name


def test_params_get_block_reads_data_as_jax(tmp_path):
    """F8 case 2: ``nd.relu(self.fc(x)) * self.scale.data()`` in a
    user's ``forward``: the JAX package's output and gradients, the
    scale's included."""
    x = _x(5, 2, seed=4)
    jnet, net = _pair(JSCALED, TSCALED, x, tmp_path, seed=1)
    with jmx.autograd.record():
        jy = jnet(jmx.nd.array(x))
        (jy * jy).sum().backward()
    with tmx.cpu(), tmx.autograd.record():
        y = net(tmx.nd.array(x))
        (y * y).sum().backward()
    np.testing.assert_allclose(y.asnumpy(), jy.asnumpy(), **TOL)
    np.testing.assert_allclose(net.scale.grad().asnumpy(),
                               jnet.scale.grad().asnumpy(), **GRAD)
    np.testing.assert_allclose(net.fc.weight.grad().asnumpy(),
                               jnet.fc.weight.grad().asnumpy(), **GRAD)


def test_user_forward_called_with_tensors_gets_tensors():
    """Called with tensors, a user's ``forward`` gets tensors and gives
    tensors, as before; the port's layers inside it too."""
    seen = []

    class Probe(tmx.gluon.Block):
        def __init__(self):
            super().__init__()
            self.fc = tmx.gluon.nn.Dense(2, in_units=3, device="cpu")

        def forward(self, x):
            seen.append(type(x))
            return self.fc(x) * 2

    with tmx.cpu():
        net = Probe()
        net.initialize()
        out = net(torch.ones(1, 3))
        out_nd = net(tmx.nd.ones((1, 3)))
    assert seen == [torch.Tensor, NDArray]
    assert isinstance(out, torch.Tensor) and isinstance(out_nd, NDArray)
    np.testing.assert_array_equal(out.detach().numpy(), out_nd.asnumpy())


def _super_blocks(mx, seen):
    """User ``forward``s that reach another ``forward`` through
    ``super()``, written once over either package: a subclass of the
    port's ``nn.Dense`` scaling its output, and a user class over a user
    class.  ``seen`` collects the type of what each ``super()`` call
    returned (NDArray or not)."""
    gluon, nd, nn = mx.gluon, mx.nd, mx.gluon.nn

    class Doubled(nn.Dense):
        def __init__(self, **kwargs):
            super().__init__(2, in_units=3, **kwargs)

        def forward(self, x):
            y = super().forward(x)
            seen.append(isinstance(y, mx.nd.NDArray))
            return y * 2

    class Inner(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc = nn.Dense(2, in_units=3)

        def forward(self, x):
            return nd.relu(self.fc(x)) + 1

    class Outer(Inner):
        def forward(self, x):
            y = super().forward(x)
            seen.append(isinstance(y, mx.nd.NDArray))
            return nd.tanh(y) * self.fc.weight.data().sum()

    return Doubled, Outer


@pytest.mark.parametrize("which", [0, 1], ids=["port_layer", "user_block"])
def test_user_forward_through_super_matches_jax(which, tmp_path):
    """A user ``forward`` that calls ``super().forward``: on a subclass
    of the port's ``Dense`` the port's ``forward`` takes the NDArray and
    gives one back; over another user class the inner ``forward`` returns
    NDArrays, as in the JAX package.  Outputs and gradients under
    ``record()`` match the JAX package's."""
    jseen, tseen = [], []
    jcls = _super_blocks(jmx, jseen)[which]
    tcls = _super_blocks(tmx, tseen)[which]
    x = _x(4, 3, seed=7)
    jnet, net = _pair(jcls, tcls, x, tmp_path, seed=2)
    del jseen[:], tseen[:]
    with jmx.autograd.record():
        jy = jnet(jmx.nd.array(x))
        (jy * jy).sum().backward()
    with tmx.cpu(), tmx.autograd.record():
        y = net(tmx.nd.array(x))
        (y * y).sum().backward()
    assert isinstance(y, NDArray)
    assert tseen == jseen == [True]
    np.testing.assert_allclose(y.asnumpy(), jy.asnumpy(), **TOL)
    jparams = jnet._collect_params_with_prefix()
    tparams = net._param_handles()
    assert sorted(jparams) == sorted(tparams)
    for name, p in jparams.items():
        np.testing.assert_allclose(tparams[name].grad().asnumpy(),
                                   p.grad().asnumpy(), **GRAD)
    if which == 0:              # tensors in: tensors throughout
        with tmx.cpu():
            out = net(torch.from_numpy(x))
        assert isinstance(out, torch.Tensor) and tseen[-1] is False
        np.testing.assert_allclose(out.detach().numpy(), y.asnumpy(), **TOL)


@pytest.mark.parametrize("layer", ["dense", "batchnorm"])
def test_parameter_attributes_work_as_handles(layer, tmp_path):
    """F8 case 3: ``Dense.weight.data()`` and ``BatchNorm.running_mean
    .data()`` as in the JAX package; ``.grad()`` after a backward and
    ``.set_data()`` on the attribute; torch's ``.data``/``.grad`` reads
    unchanged."""
    x = _x(4, 3, seed=5)
    if layer == "dense":
        jl, tl = (lambda: jmx.gluon.nn.Dense(2, in_units=3),
                  lambda: tmx.gluon.nn.Dense(2, in_units=3))
        names = ("weight", "bias")
    else:
        jl, tl = (lambda: jmx.gluon.nn.BatchNorm(in_channels=3),
                  lambda: tmx.gluon.nn.BatchNorm(in_channels=3))
        names = ("gamma", "beta", "running_mean", "running_var")
    jnet, net = _pair(jl, tl, x, tmp_path)
    with jmx.autograd.record():
        jnet(jmx.nd.array(x)).sum().backward()
    with tmx.cpu(), tmx.autograd.record():
        net(tmx.nd.array(x)).sum().backward()
    for name in names:
        got, want = getattr(net, name), getattr(jnet, name)
        np.testing.assert_allclose(got.data().asnumpy(),
                                   want.data().asnumpy(), **TOL)
        assert isinstance(got.data(), NDArray)
        assert torch.equal(got.data, got.detach())       # torch's .data
        if name in ("weight", "bias", "gamma", "beta"):
            np.testing.assert_allclose(got.grad().asnumpy(),
                                       want.grad().asnumpy(), **GRAD)
            assert torch.equal(got.grad.clone(), got.grad().data())
    first = names[0]
    new = _x(*getattr(net, first).shape, seed=6)
    getattr(jnet, first).set_data(jmx.nd.array(new))
    with tmx.cpu():
        getattr(net, first).set_data(tmx.nd.array(new))
        got = net(tmx.nd.array(x))
    np.testing.assert_array_equal(getattr(net, first).data().asnumpy(),
                                  getattr(jnet, first).data().asnumpy())
    np.testing.assert_allclose(got.asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), **TOL)


def test_parameter_attribute_keeps_its_class_through_to_and_cast():
    """``net.double()`` and ``cast`` keep the attribute's ``data()`` (the
    handle follows the tensor), and ops on it give plain tensors."""
    with tmx.cpu():
        net = tmx.gluon.nn.BatchNorm(in_channels=2)
        net.initialize()
        net.double()
        assert net.running_var.data().dtype == np.float64
        assert type(net.running_var * 2) is torch.Tensor
        d = tmx.gluon.nn.Dense(2, in_units=2)
        d.initialize()
        d.cast("float64")
        assert d.weight.data().dtype == np.float64
        assert type(d.weight + 1) is torch.Tensor


# -- F9: negative-step slices --------------------------------------------


_GET_CASES = [
    ((3,), np.s_[::-2]),
    ((2, 3, 4), np.s_[1, ::-1, 1:3]),
    ((5, 6), np.s_[4:0:-2, ::-3]),
    ((5, 6), np.s_[..., ::-1]),
    ((5, 6), np.s_[None, 3::-1]),
    ((5, 6), np.s_[0:3:-1]),
]


@pytest.mark.parametrize("shape,key", _GET_CASES)
def test_negative_step_reads_match_jax(shape, key):
    a = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    want = jmx.nd.array(a)[key].asnumpy()
    with tmx.cpu():
        got = tmx.nd.array(a)[key].asnumpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key,value", [
    (np.s_[:, ::-1], [1.0, 2.0, 3.0]),
    (np.s_[1, ::-2], 7.0),
    (np.s_[::-1, 2:0:-1], [[1.0, 2.0], [3.0, 4.0]]),
])
def test_negative_step_writes_match_jax(key, value):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    jx = jmx.nd.array(a)
    jx[key] = jmx.nd.array(value) if isinstance(value, list) else value
    with tmx.cpu():
        x = tmx.nd.array(a)
        x[key] = tmx.nd.array(value) if isinstance(value, list) else value
        got = x.asnumpy()
    np.testing.assert_array_equal(got, jx.asnumpy())


def test_negative_step_read_is_recorded():
    """A negative-step read inside ``record()`` passes the gradient back
    to the elements it read, as the JAX package's does."""
    a = _x(5)
    jx = jmx.nd.array(a)
    jx.attach_grad()
    with jmx.autograd.record():
        (jx[::-2] * jmx.nd.array([1.0, 2.0, 3.0])).sum().backward()
    with tmx.cpu():
        x = tmx.nd.array(a)
        x.attach_grad()
        with tmx.autograd.record():
            (x[::-2] * tmx.nd.array([1.0, 2.0, 3.0])).sum().backward()
        got = x.grad.asnumpy()
    np.testing.assert_array_equal(got, jx.grad.asnumpy())


def test_negative_step_with_an_array_index_raises():
    with tmx.cpu():
        x = tmx.nd.array(np.arange(6.0).reshape(2, 3))
        with pytest.raises(MXNetError):
            x[tmx.nd.array([0, 1]), ::-1]


# -- F10: dtypes of integer and boolean reductions --------------------------


_INTS = ["int32", "int8", "bool", "uint8"]


def _int_input(dtype):
    rs = np.random.RandomState(7)
    if dtype == "bool":
        return rs.uniform(size=(3, 4)) > 0.4
    return rs.randint(0, 5, size=(3, 4)).astype(dtype)


@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("dtype", _INTS)
@pytest.mark.parametrize("op", ["sum", "prod", "nansum", "nanprod",
                                "cumsum"])
def test_integer_reductions_keep_jax_dtypes(op, dtype, axis):
    a = _int_input(dtype)
    kw = {} if axis is None else {"axis": axis}
    want = getattr(jmx.nd, op)(jmx.nd.array(a, dtype=dtype), **kw)
    with tmx.cpu():
        got = getattr(tmx.nd, op)(tmx.nd.array(a, dtype=dtype), **kw)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("dtype", _INTS)
def test_sum_method_keeps_jax_dtype(dtype):
    a = _int_input(dtype)
    want = jmx.nd.array(a, dtype=dtype).sum(axis=1)
    with tmx.cpu():
        got = tmx.nd.array(a, dtype=dtype).sum(axis=1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_int32_sum_wraps_as_jax():
    """A sum past int32's range wraps in 32 bits, as jnp's does."""
    a = np.full((4,), 2 ** 30 + 7, dtype=np.int32)
    want = jmx.nd.sum(jmx.nd.array(a, dtype="int32"))
    with tmx.cpu():
        got = tmx.nd.sum(tmx.nd.array(a, dtype="int32"))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_64_bit_arrays_stay_64_bit(dtype):
    """A deliberate deviation: MXNet keeps 64-bit arrays, where the JAX
    package (64-bit types off) narrows them; the sum follows."""
    with tmx.cpu():
        x = tmx.nd.array([1, 2, 3], dtype=dtype)
        assert x.dtype == np.dtype(dtype)
        assert tmx.nd.sum(x).dtype == np.dtype(dtype)


# -- F13: division by and of a Python number -----------------------------

_F13_X = np.linspace(0.1, 10, 2000, dtype=np.float32)


@pytest.mark.parametrize("scalar", [255.0, 3.0, 0.1])
@pytest.mark.parametrize("op", ["_div_scalar", "_rdiv_scalar"])
def test_scalar_division_ops_are_true_divisions_as_jax(op, scalar):
    """``_rdiv_scalar(x, 255.0)`` was ``255.0 / x``, which torch computes
    as ``reciprocal(x) * 255``: 491 of these 2,000 values differed."""
    import jax.numpy as jnp

    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    want = np.asarray(jreg.get(op).forward(jnp.asarray(_F13_X),
                                           scalar=scalar))
    got = treg.get(op).forward(torch.from_numpy(_F13_X),
                               scalar=scalar).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scalar", [255.0, 3.0, 0.1])
def test_ndarray_division_by_and_of_a_number_as_jax(scalar):
    """NDArray ``/`` with a Python number, both ways, equals the JAX
    package's ops (true divisions), and ``c / x`` its NDArray too.  The
    JAX package's own NDArray ``x / c`` is jit-compiled with ``c`` a
    constant, which XLA turns into a product by its reciprocal (1,413 of
    these 2,000 values differ from its op at 255; ROADMAP.md, R12): the
    port follows the op."""
    import jax.numpy as jnp

    from mxnet_tpu.ops import registry as jreg

    with tmx.cpu():
        ta = tmx.nd.array(_F13_X)
        got = [(ta / scalar).asnumpy(), (scalar / ta).asnumpy()]
    x = jnp.asarray(_F13_X)
    want = [np.asarray(jreg.get(op).forward(x, scalar=scalar))
            for op in ("_div_scalar", "_rdiv_scalar")]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1],
                                  (scalar / jmx.nd.array(_F13_X)).asnumpy())


@pytest.mark.parametrize("scalar", [255.0, 3, 0.1])
@pytest.mark.parametrize("op", ["_div_scalar", "_rdiv_scalar"])
def test_scalar_division_of_int32_keeps_jax_type_and_values(op, scalar):
    """An int32 input gives float32, as it did and as the JAX package's
    does, with the JAX package's values."""
    import jax.numpy as jnp

    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    x = np.arange(-300, 301, 7, dtype=np.int32)
    x = x[x != 0]
    want = np.asarray(jreg.get(op).forward(jnp.asarray(x), scalar=scalar))
    got = treg.get(op).forward(torch.from_numpy(x), scalar=scalar).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- F11: slicing Sequential ----------------------------------------------


@pytest.mark.parametrize("cls", ["Sequential", "HybridSequential"])
@pytest.mark.parametrize("key", [np.s_[:1], np.s_[1:], np.s_[::-1]])
def test_sequential_slice_is_a_block_as_in_jax(cls, key, tmp_path):
    def build(mx):
        net = getattr(mx.gluon.nn, cls)()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(2, in_units=2),
                    mx.gluon.nn.Dense(2, in_units=2, activation="tanh"))
        return net

    x = _x(1, 2, seed=8)
    jnet, net = _pair(lambda: build(jmx), lambda: build(tmx), x, tmp_path)
    jpart = jnet[key]
    with tmx.cpu():
        part = net[key]
        got = part(tmx.nd.array(x))
    assert type(part).__name__ == type(jpart).__name__ == cls
    assert len(part) == len(jpart)
    assert type(net[0]).__name__ == "Dense"
    np.testing.assert_allclose(got.asnumpy(),
                               jpart(jmx.nd.array(x)).asnumpy(), **TOL)


# -- F12: public names of the done modules ----------------------------------


# The done modules, as attribute paths from the top level.
_DONE = ["", "autograd", "context", "engine", "gluon", "gluon.nn",
         "gluon.loss", "gluon.data", "gluon.model_zoo",
         "gluon.model_zoo.vision", "nd", "nd.random", "initializer",
         "optimizer", "lr_scheduler", "metric", "random", "layout", "amp",
         "rtc", "operator", "telemetry", "name", "registry", "parallel",
         "sharding", "contrib", "numpy", "numpy.linalg", "numpy.random",
         "numpy_extension", "util", "nd.sparse", "io", "gluon.contrib",
         "gluon.contrib.nn"]
# mx.contrib's names that come with S9: each raises MXNetError naming it
_CONTRIB_S9 = ["onnx", "text", "tensorboard", "svrg_optimization", "io",
               "autograd", "DataLoaderIter", "TrainingStateScope"]
# Each public name of those modules that the port still lacks, with the
# slice that brings it (ROADMAP.md §1), or why it has no counterpart.
_MISSING = {
    "RNN (ROADMAP.md §1 item 4)": ["gluon.rnn", "nd.RNN", "nd.rnn",
                                   "numpy_extension.rnn"],
    "S8": ["kvstore", "gluon.nn.SyncBatchNorm", "Trainer.kvstore",
           "NDArray.sharding", "parallel.HostPipeline", "parallel.Mesh",
           "parallel.MeshScope", "parallel.as_jax_mesh",
           "parallel.current_mesh",
           "parallel.data_sharding", "parallel.global_mesh",
           "parallel.global_to_host_local", "parallel.gpipe",
           "parallel.gpipe_loss_fn", "parallel.host_local_to_global",
           "parallel.init_multihost", "parallel.make_mesh",
           "parallel.megatron_rule", "parallel.mesh", "parallel.moe",
           "parallel.moe_ffn", "parallel.moe_ffn_sharded",
           "parallel.multihost", "parallel.partition_llama",
           "parallel.pattern_rule", "parallel.pipeline",
           "parallel.replicated", "parallel.ring_attention",
           "parallel.ring_attention_sharded", "parallel.shard_map",
           "parallel.shard_params", "parallel.sync_global_devices",
           "parallel.tp_rules", "sharding.Mesh", "sharding.as_jax_mesh",
           "sharding.canonicalize_spec", "sharding.current_jax_mesh",
           "sharding.current_mesh", "sharding.maybe_verify",
           "sharding.named_sharding", "sharding.pop_mesh",
           "sharding.push_mesh", "sharding.record_reshard",
           "sharding.reshard", "sharding.spec", "sharding.spec_axes_label",
           "sharding.spec_from_wire", "sharding.spec_to_wire",
           "sharding.verify", "sharding.verify_enabled",
           "sharding.verify_spec"],
    "S9": ["HybridBlock.export", "HybridBlock.lint", "gluon.SymbolBlock",
           "AttrScope", "Monitor", "callback",
           "deploy", "error", "executor", "image", "library", "log",
           "model", "module", "monitor", "profiler", "recordio", "rnn",
           "runtime", "sym", "symbol", "test_utils", "visualization"]
    + ["contrib." + n for n in _CONTRIB_S9]
    + ["gluon.contrib." + n for n in ("estimator", "rnn", "cnn", "data")],
    "none: no TPU in the port": ["tpu", "num_tpus", "context.tpu",
                                 "context.num_tpus", "Context.jax_device"],
    "none: JAX's tape and keys, not torch's": [
        "autograd.TapeNode", "autograd.current_backward_gen",
        "random.current_key", "random.next_key", "random.trace_key_scope",
        "engine.bulk_trace_count"],
    "none: an import of context.current_context": [
        "nd.random.current_context"],
}
_CLASSES = {"gluon.Block": "gluon.Block",
            "HybridBlock": "gluon.HybridBlock", "NDArray": "nd.NDArray",
            "gluon.Parameter": "gluon.Parameter",
            "gluon.ParameterDict": "gluon.ParameterDict",
            "Trainer": "gluon.Trainer", "Context": "Context",
            "JitTrainStep": "parallel.JitTrainStep"}


def _get(pkg, path):
    """The object at ``path``, or None where it is missing or raises
    ``MXNetError`` naming the slice that brings it."""
    obj = pkg
    for part in [p for p in path.split(".") if p]:
        try:
            obj = getattr(obj, part, None)
        except MXNetError:
            return None
        if obj is None:
            return None
    return obj


def _foreign(obj):
    """A module or object the JAX package imports from outside itself
    (``jax``, ``jnp``, ``threading``, ``annotations``)."""
    mod = obj.__name__ if isinstance(obj, types.ModuleType) \
        else getattr(obj, "__module__", None) or type(obj).__module__
    return not str(mod).startswith("mxnet_tpu")


def _public_names():
    """The public names of the done modules and classes as a fresh
    import of the JAX package has them: submodules that other tests
    import later become attributes too, so the names are read in a
    process of their own."""
    import json
    import subprocess
    import sys

    code = ("import json, sys\n"
            "sys.path.insert(0, %r)\n"
            "import test_torch_parity_fixes as t\n"
            "print(json.dumps(list(t._names_here())))\n"
            % os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def _names_here():
    for path in _DONE:
        mod = _get(jmx, path)
        for name in dir(mod):
            if not name.startswith("_") \
                    and not _foreign(getattr(mod, name)):
                yield "%s.%s" % (path, name) if path else name
    for short, path in _CLASSES.items():
        for name in dir(_get(jmx, path)):
            if not name.startswith("_"):
                yield "%s.%s" % (short, name)


def test_public_names_of_the_done_modules_exist_or_name_their_slice():
    """Every public name of the JAX package's done modules and classes
    is in the port, or listed in ``_MISSING`` with the slice that brings
    it; and every listed name is still missing (a name that lands comes
    off the list)."""
    listed = {n for names in _MISSING.values() for n in names}
    missing = set()
    for name in _public_names():
        path = name
        for short, full in _CLASSES.items():
            if name.startswith(short + "."):
                path = full + name[len(short):]
        if _get(tmx, path) is None:
            missing.add(name)
    assert not missing - listed, sorted(missing - listed)
    assert not listed - missing, sorted(listed - missing)


def test_contrib_has_amp_and_quantization_and_names_s9_for_the_rest():
    """``mx.contrib`` as in the JAX package: ``amp`` is ``mx.amp``,
    ``quantization`` is ported, and each other name raises
    ``MXNetError`` naming S9, also through ``from ... import``."""
    from mxnet_tpu_torch import contrib

    assert contrib.amp is tmx.amp and jmx.contrib.amp is jmx.amp
    assert callable(contrib.quantization.quantize_net_v2)
    for name in _CONTRIB_S9:
        assert hasattr(jmx.contrib, name), name
        with pytest.raises(MXNetError, match="S9"):
            getattr(contrib, name)
    with pytest.raises(MXNetError, match="S9"):
        exec("from mxnet_tpu_torch.contrib import onnx", {})
    with pytest.raises(AttributeError):
        contrib.no_such_name


@pytest.mark.parametrize("name", [
    "autograd.set_recording", "autograd.set_training",
    "gluon.model_zoo.get_model", "NDArray", "cpu_pinned",
    "context.cpu_pinned", "layout_scope", "set_default_layout",
    "Context.empty_cache"])
def test_names_of_the_fault_report_exist(name):
    assert _get(tmx, name) is not None and _get(jmx, name) is not None


def test_set_recording_and_set_training_return_the_previous_state():
    for mx in (jmx, tmx):
        assert mx.autograd.set_recording(True) is False
        assert mx.autograd.is_recording()
        assert mx.autograd.set_recording(False) is True
        assert not mx.autograd.is_recording()
        assert mx.autograd.set_training(True) is False
        assert mx.autograd.is_training()
        assert mx.autograd.set_training(False) is True


def test_set_recording_records_as_record_does():
    a = _x(3)
    grads = []
    for mx in (jmx, tmx):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            x = mx.nd.array(a)
            x.attach_grad()
            prev = mx.autograd.set_recording(True)
            try:
                y = (x * x).sum()
            finally:
                mx.autograd.set_recording(prev)
            y.backward()
            grads.append(x.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], **GRAD)


@pytest.mark.parametrize("grad_mode", [False, True])
def test_set_recording_pair_restores_grad_mode(grad_mode):
    """``set_recording(True)`` then ``set_recording(False)`` leaves
    torch's grad mode as it was before the pair, as a ``record()`` scope
    does."""
    prev_mode = torch.is_grad_enabled()
    try:
        torch.set_grad_enabled(grad_mode)
        assert tmx.autograd.set_recording(True) is False
        assert torch.is_grad_enabled()
        assert tmx.autograd.set_recording(False) is True
        assert torch.is_grad_enabled() is grad_mode
        with tmx.autograd.record():
            pass
        assert torch.is_grad_enabled() is grad_mode
    finally:
        torch.set_grad_enabled(prev_mode)


def test_model_zoo_get_model_and_cpu_pinned():
    with tmx.cpu():
        net = tmx.gluon.model_zoo.get_model("resnet18_v1", classes=3)
    assert type(net).__name__ == type(
        jmx.gluon.model_zoo.get_model("resnet18_v1", classes=3)).__name__
    ctx = tmx.cpu_pinned()
    assert ctx == tmx.context.cpu_pinned() and ctx != tmx.cpu()
    assert (ctx.device_type, ctx.device_typeid) == (
        jmx.cpu_pinned().device_type, jmx.cpu_pinned().device_typeid)
    x = tmx.nd.array([1.0, 2.0], ctx=ctx)
    assert x.context == ctx and x.asnumpy().tolist() == [1.0, 2.0]
    with tmx.layout_scope("NCHW"):
        assert not tmx.layout.is_channel_last()


def test_parameter_tensors_are_freed_with_their_block():
    """A registered tensor holds its handle weakly: once the block is
    gone, its parameters and their gradients are freed (a cycle through
    a tensor's attributes is never collected)."""
    import gc
    import weakref

    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        with tmx.autograd.record():
            out = net(tmx.nd.ones((4, 3))).sum()
        out.backward()
        assert net.weight.grad().shape == (2, 3)
        refs = [weakref.ref(net.weight), weakref.ref(net.weight.grad)]
        del net, out
        gc.collect()
    assert all(r() is None for r in refs)
