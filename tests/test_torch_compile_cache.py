"""The port's compile cache and saved signatures (``compile_cache``,
``hybridize(aot=path)``, ``JitTrainStep.save_executable`` /
``load_executable``), on the CPU.

The disk cache: the ``MXNET_COMPILE_CACHE*`` contract, the nvcc
libraries' and NVRTC cubins' requests, hits and writes, eviction under
the budget by least-recent use (counted, and harmless to a process that
mapped the evicted library), and the telemetry counters.  The bundles:
the port's own format, refused on a bad magic or another card's
capability, warned on another torch version.  On the CPU nothing is
captured (graphs are the card's), so the saved signatures are checked
by their entries, the checks at load, and the outputs: a fresh process
loads the bundles and gives the exporting process's outputs bitwise,
and both are held against the JAX package's in-process outputs from the
same weights (rtol 1e-5; the JAX package's own fresh-process round trip
through MXAOT1 is not used).
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile_cache as cc
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.telemetry import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache():
    """The module's state, restored after the test."""
    state, stats = dict(cc._state), dict(cc._stats)
    memory = dict(cc._memory)
    yield cc
    cc._state.clear()
    cc._state.update(state)
    cc._stats.clear()
    cc._stats.update(stats)
    cc._memory.clear()
    cc._memory.update(memory)


def _delta(before):
    now = cc.stats()
    return {k: now[k] - before[k] for k in now}


# -- the env contract ------------------------------------------------------

def test_env_contract(cache, tmp_path):
    d = str(tmp_path / "cache")
    for env, on, where in (
            ({"MXNET_COMPILE_CACHE": "0"}, False, None),
            ({"MXNET_COMPILE_CACHE": "off", "MXNET_COMPILE_CACHE_DIR": d},
             False, None),
            ({"MXNET_COMPILE_CACHE": "1"}, True, cc.DEFAULT_DIR),
            ({"MXNET_COMPILE_CACHE": "yes", "MXNET_COMPILE_CACHE_DIR": d},
             True, d),
            ({"MXNET_COMPILE_CACHE": d}, True, d),
            ({"MXNET_COMPILE_CACHE_DIR": d}, True, d),
            ({}, torch.cuda.is_available(), cc.DEFAULT_DIR),
            ({"MXNET_COMPILE_CACHE": "auto"}, torch.cuda.is_available(),
             cc.DEFAULT_DIR)):
        assert cc.configure(env) is on, env
        assert cc.enabled() is on
        assert cc.cache_dir() == (where if on else None), env
        if on:
            assert cc.library_dir() == where
        else:
            lib = cc.library_dir()
            assert os.path.dirname(lib) == cc.DEFAULT_DIR
            assert os.path.basename(lib).startswith("private-%d-"
                                                    % os.getpid())
    assert os.path.basename(cc.DEFAULT_DIR) == "build"
    cc.configure({"MXNET_COMPILE_CACHE": "1",
                  "MXNET_COMPILE_CACHE_MIN_SECS": "x",
                  "MXNET_COMPILE_CACHE_BUDGET_MB": "2.5"})
    assert cc._state["min_secs"] == 0.0 and cc._state["budget_mb"] == 2.5


def test_libraries_are_requested_hit_and_written_through_the_cache(
        cache, tmp_path):
    """A library in the directory is a hit (no nvcc runs: there is none
    here), touched for its recency; with the cache off the process's
    own directory is used, so nothing is reused across processes."""
    d = str(tmp_path)
    cc.configure({"MXNET_COMPILE_CACHE": d})
    path = _build.library_path(pa._SOURCE)
    assert os.path.dirname(path) == d and pa.library_path() == path
    with open(path, "wb") as f:
        f.write(b"\0" * 10)
    os.utime(path, (1000, 1000))
    before = cc.stats()
    assert _build.build(pa._SOURCE) == path
    assert _delta(before) == dict(_delta(before), requests=1, hits=1,
                                  writes=0, misses=0)
    assert os.stat(path).st_mtime > 1000
    cc.configure({"MXNET_COMPILE_CACHE": "0"})
    private = _build.library_path(pa._SOURCE)
    assert private != path and private.startswith(_build.BUILD_DIR)
    assert os.path.basename(private) == os.path.basename(path)


def _entry(d, name, size, mtime):
    path = os.path.join(d, name)
    with open(path, "wb") as f:
        f.write(b"\0" * size)
    os.utime(path, (mtime, mtime))
    return path


def test_budget_evicts_least_recently_used_and_counts(cache, tmp_path):
    d = str(tmp_path)
    mb = 1 << 20
    old = _entry(d, "flash_attention-aaa.so", mb, 1000)
    mid = _entry(d, "nvrtc-bbb.cubin", mb, 2000)
    new = _entry(d, "optimizer_ops-ccc.so", mb, 3000)
    keep = [_entry(d, "notes.txt", 4 * mb, 10),
            _entry(d, "x.so.tmp.17", 4 * mb, 10)]
    os.makedirs(os.path.join(d, "variants"))
    before = cc.stats()
    cc.configure({"MXNET_COMPILE_CACHE": d,
                  "MXNET_COMPILE_CACHE_BUDGET_MB": "2.5"})
    assert not os.path.exists(old) and os.path.exists(mid)
    assert _delta(before)["evictions"] == 1
    # a hit makes an entry the most recent
    assert cc.library_request(mid)
    assert cc.enforce_budget(1.5) == 1
    assert os.path.exists(mid) and not os.path.exists(new)
    assert all(os.path.exists(p) for p in keep)
    assert _delta(before)["evictions"] == 2
    assert cc.cache_size_bytes() == mb
    assert cc.enforce_budget(0) == 0           # no budget: nothing goes


def _mapped_libm():
    ctypes.CDLL("libm.so.6")
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libm.so"):
                return path
    pytest.fail("libm is not mapped")


def test_evicting_a_loaded_library_leaves_the_process_working(cache,
                                                              tmp_path):
    d = str(tmp_path)
    lib_path = _entry(d, "libm_copy-000.so", 0, 1000)
    with open(_mapped_libm(), "rb") as src, open(lib_path, "wb") as dst:
        dst.write(src.read())
    os.utime(lib_path, (1000, 1000))
    lib = ctypes.CDLL(lib_path)
    lib.cos.restype, lib.cos.argtypes = ctypes.c_double, [ctypes.c_double]
    cc.configure({"MXNET_COMPILE_CACHE": d})
    assert cc.enforce_budget(1e-6) == 1 and not os.path.exists(lib_path)
    assert lib.cos(0.0) == 1.0


def test_nvrtc_cubins_are_kept_by_key(cache, tmp_path):
    key = cc.cubin_key("src", "a.cu", ["-O3"], ["k<float>"], "sm_90a",
                       (12, 8))
    for changed in (("src2", "a.cu", ["-O3"], ["k<float>"], "sm_90a",
                     (12, 8)),
                    ("src", "a.cu", ["-O2"], ["k<float>"], "sm_90a",
                     (12, 8)),
                    ("src", "a.cu", ["-O3"], ["k<float>"], "sm_80",
                     (12, 8)),
                    ("src", "a.cu", ["-O3"], ["k<float>"], "sm_90a",
                     (12, 9)),
                    ("src", "a.cu", ["-O3"], [], "sm_90a", (12, 8))):
        assert cc.cubin_key(*changed) != key
    cc.configure({"MXNET_COMPILE_CACHE": str(tmp_path)})
    before = cc.stats()
    assert cc.cubin_get(key) is None
    cc.cubin_put(key, b"\x7fELF\ncubin", {"k<float>": "_Z1kIfEvv"}, 0.3)
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "nvrtc-%s.cubin" % key))
    cc._memory.clear()           # as a fresh process: from the disk
    assert cc.cubin_get(key) == (b"\x7fELF\ncubin",
                                 {"k<float>": "_Z1kIfEvv"})
    assert _delta(before) == dict(_delta(before), requests=2, hits=1,
                                  writes=1)
    # under MXNET_COMPILE_CACHE_MIN_SECS: this process's memory only
    cc.configure({"MXNET_COMPILE_CACHE": str(tmp_path / "m"),
                  "MXNET_COMPILE_CACHE_MIN_SECS": "1"})
    cc.cubin_put("fast", b"c", {}, 0.2)
    assert cc.cubin_get("fast") == (b"c", {})
    assert not os.path.exists(str(tmp_path / "m"))
    # off: memory only, never a file
    cc.configure({"MXNET_COMPILE_CACHE": "0"})
    cc.cubin_put("off", b"d", {}, 5.0)
    assert cc.cubin_get("off") == (b"d", {})


def test_counters_are_published_through_telemetry(cache, tmp_path):
    cc.configure({"MXNET_COMPILE_CACHE": str(tmp_path)})
    cc.save_bundle(str(tmp_path / "b.aot"), {"a": 1, "b": 2})
    text = metrics.prometheus_text()
    for name in ("hits", "misses", "writes", "evictions", "aot_loads",
                 "aot_saves", "aot_unusable"):
        assert "mxnet_compile_cache_%s_total" % name in text
    assert "mxnet_compile_cache_size_bytes" in text
    line = [ln for ln in text.splitlines()
            if ln.startswith("mxnet_compile_cache_aot_saves_total")][0]
    assert float(line.split()[-1]) == cc.stats()["aot_saves"] >= 2


# -- bundles ---------------------------------------------------------------

def test_bundle_round_trip_and_refusals(cache, tmp_path):
    path = str(tmp_path / "b.aot")
    entries = {"k": {"signature": {"args": [], "training": False},
                     "names": ["a", "b"], "n": 3}}
    cc.save_bundle(path, entries, meta={"block": "net0"})
    assert sorted(os.listdir(str(tmp_path))) == ["b.aot"]     # atomic
    with open(path, "rb") as f:
        assert f.read(9) == b"MXTTAOT1\n"
    doc = cc.load_bundle(path)
    assert doc["entries"] == entries and doc["meta"] == {"block": "net0"}
    assert doc["torch"] == torch.__version__
    assert doc["cuda"] == torch.version.cuda
    assert doc["capability"] == cc.device_doc()["capability"]
    body = json.loads(open(path, "rb").read()[9:].decode())

    def write(name, raw):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(raw)
        return p

    with pytest.raises(MXNetError, match="bad magic"):
        cc.load_bundle(write("mxaot1.aot", b"MXAOT1\n" + b"\0" * 40))
    with pytest.raises(MXNetError, match="failed to read"):
        cc.load_bundle(write("torn.aot", b"MXTTAOT1\n{\"entries\":"))
    other = dict(body, capability=[8, 0], device="another card")
    with pytest.raises(MXNetError, match="capability"):
        cc.load_bundle(write("cap.aot", b"MXTTAOT1\n"
                             + json.dumps(other).encode()))
    older = dict(body, torch="1.0.0")
    with pytest.warns(UserWarning, match="torch 1.0.0"):
        doc = cc.load_bundle(write("ver.aot", b"MXTTAOT1\n"
                                   + json.dumps(older).encode()))
    assert doc["entries"] == entries


# -- hybridize(aot=) -------------------------------------------------------

def _net(seed=0, bn=True):
    tmx.gluon.block._name_counter.clear()
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=6, device="cpu"))
        if bn:
            net.add(nn.BatchNorm(in_channels=8, device="cpu"))
        net.add(nn.Dense(3, in_units=8, device="cpu"))
    net.initialize(tmx.init.Xavier(),
                   generator=torch.Generator().manual_seed(seed))
    return net


X = torch.arange(12, dtype=torch.float32).reshape(2, 6) / 12


def test_aot_entries_are_written_per_signature(cache, tmp_path):
    path = str(tmp_path / "net.aot")
    net = _net()
    net.hybridize(aot=path)
    before = cc.stats()
    with torch.no_grad():
        y = net(X)
        net(X)                              # the same signature
        net(torch.ones(5, 6))               # a second one
        with tmx.autograd.train_mode():
            net(X)                          # a third: training
    assert _delta(before)["aot_saves"] == 1 + 2 + 3
    doc = cc.load_bundle(path)
    assert doc["meta"] == {"block": net.name}
    sigs = sorted((tuple(e["signature"]["args"][0]["shape"]),
                   e["signature"]["training"])
                  for e in doc["entries"].values())
    assert sigs == [((2, 6), False), ((2, 6), True), ((5, 6), False)]
    names = [p.name for p in net.collect_params().values()]
    for e in doc["entries"].values():
        assert e["param_names"] == names and e["n_outputs"] == 1
        assert e["aux_names"] == [n for n in names if "running" in n] \
            and len(e["aux_names"]) == 2
        assert e["signature"]["args"][0]["dtype"] == "float32"
        assert e["signature"]["args"][0]["format"] == "contiguous"
        assert e["signature"]["args"][0]["device"] == "cpu"
    # a fresh net of the same architecture reads them and agrees
    again = _net()
    again.hybridize(aot=path)
    with torch.no_grad():
        assert torch.equal(again(X), y)
    assert len(cc.load_bundle(path)["entries"]) == 3       # nothing new
    assert again.stats()["captures"] == 0                  # the CPU


def test_aot_bundle_of_another_architecture_raises_naming_both(cache,
                                                               tmp_path):
    path = str(tmp_path / "net.aot")
    net = _net()
    net.hybridize(aot=path)
    with torch.no_grad():
        net(X)
    other = _net(bn=False)
    with pytest.raises(MXNetError) as e:
        other.hybridize(aot=path)
    msg = str(e.value)
    assert "batchnorm0_gamma" in msg and "architecture changed" in msg
    assert str([p.name for p in other.collect_params().values()]) in msg


def test_an_unusable_bundle_warns_is_counted_and_the_block_runs(cache,
                                                                tmp_path):
    path = str(tmp_path / "bad.aot")
    with open(path, "wb") as f:
        f.write(b"MXAOT1\n" + b"\0" * 64)
    net, ref = _net(), _net()
    before = cc.stats()
    with pytest.warns(UserWarning, match="unusable bundle"):
        net.hybridize(aot=path)
    assert _delta(before)["aot_unusable"] == 1
    with torch.no_grad():
        assert torch.equal(net(X), ref(X))


def test_an_aot_block_still_records_gradients(cache, tmp_path):
    """A recorded call is not saved and still gives the gradients an
    unhybridized net gives."""
    net, ref = _net(), _net()
    net.hybridize(aot=str(tmp_path / "net.aot"))
    for block in (net, ref):
        with tmx.autograd.record():
            loss = block(X).square().sum()
        loss.backward()
    for (k, p), q in zip(net._collect_params_with_prefix().items(),
                         ref._collect_params_with_prefix().values()):
        if p.requires_grad:
            assert p.grad is not None and torch.equal(p.grad, q.grad), k
    assert not os.path.exists(str(tmp_path / "net.aot"))


# -- JitTrainStep.save_executable / load_executable ------------------------

XB = np.arange(24, dtype="float32").reshape(4, 6) / 24.0
YB = np.ones((4, 3), dtype="float32")


def _step(seed=0, **opt):
    return parallel.JitTrainStep(
        _net(seed), gluon.loss.L2Loss(), "sgd",
        dict({"learning_rate": 0.05, "momentum": 0.9}, **opt))


def _state_of(step):
    return ([p.detach().clone() for p in step._params],
            [s.clone() for s in step._opt_state if s is not None],
            [b.clone() for b in step._net.buffers()],
            step._count.clone(), step._t)


def _same_state(a, b):
    return all(all(torch.equal(x, y) for x, y in zip(p, q))
               for p, q in zip(a[:3], b[:3])) \
        and torch.equal(a[3], b[3]) and a[4] == b[4]


def test_save_executable_before_the_first_step_raises(cache, tmp_path):
    with pytest.raises(MXNetError, match="first step"):
        _step().save_executable(str(tmp_path / "never.aot"))
    assert not os.path.exists(str(tmp_path / "never.aot"))


def test_load_executable_checks_at_load_and_does_not_step(cache, tmp_path):
    path, states = str(tmp_path / "step.aot"), str(tmp_path / "step.st")
    first = _step()
    first.step(XB, YB)
    first.save_executable(path)
    first.save_states(states)
    want = float(first.step(XB, YB))
    doc = cc.load_bundle(path)
    entry = doc["entries"]["step"]
    assert doc["meta"] == {"kind": "train_step"}
    assert entry["optimizer"] == "sgd" and entry["graphed"] is True
    assert entry["hyperparameters"]["momentum"] == 0.9
    assert entry["batch_sig"]["args"][0]["shape"] == [4, 6]
    assert entry["weight_sig"][0] == [[8, 6], "torch.float32", "contiguous"]

    step = _step(seed=1)
    step.step(XB, YB)                       # a live state to leave alone
    held = _state_of(step)
    before = cc.stats()
    assert step.load_executable(path, XB, YB) is step
    assert _same_state(held, _state_of(step)), "load_executable stepped"
    assert _delta(before)["aot_loads"] == 0          # nothing captured here
    fresh = _step()
    fresh.load_executable(path, XB, YB)
    fresh.load_states(states)
    assert float(fresh.step(XB, YB)) == want
    for bad, match in (
            (lambda s: s.load_executable(path, XB[:2], YB[:2]),
             "batch signature"),
            (lambda s: s.load_executable(path, XB, YB[:, :2]),
             "batch signature"),
            (lambda s: _step(momentum=0.5).load_executable(path, XB, YB),
             "hyperparameters"),
            (lambda s: parallel.JitTrainStep(
                _net(), gluon.loss.L2Loss(), "adam").load_executable(
                    path, XB, YB), "optimizer"),
            (lambda s: parallel.JitTrainStep(
                _net(bn=False), gluon.loss.L2Loss(), "sgd",
                {"learning_rate": 0.05, "momentum": 0.9}).load_executable(
                    path, XB, YB), "parameters"),
            (lambda s: parallel.JitTrainStep(
                _net(), gluon.loss.L2Loss(), "sgd",
                {"learning_rate": 0.05, "momentum": 0.9},
                graphs=False).load_executable(path, XB, YB),
             "graph setting")):
        with pytest.raises(MXNetError, match=match):
            bad(_step())
    net_path = str(tmp_path / "net.aot")
    cc.save_bundle(net_path, {"k": {}}, meta={"block": "x"})
    with pytest.raises(MXNetError, match="not a JitTrainStep bundle"):
        _step().load_executable(net_path, XB, YB)


# -- a fresh process -------------------------------------------------------

_FRESH = r"""
import sys
import numpy as np
import torch
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile_cache as cc, gluon, parallel
from mxnet_tpu_torch.gluon.model_zoo import vision

phase, tmp = sys.argv[1], sys.argv[2]
ref = np.load(tmp + "/ref.npz")
x, y = ref["x"], ref["y"]


def make():
    tmx.gluon.block._name_counter.clear()
    return vision.DenseNet(16, 8, [2, 2], classes=10, layout="NHWC",
                           device="cpu")


net = make()
if phase == "export":
    params = {k[2:]: ref[k] for k in ref.files if k.startswith("p:")}
    vision.load_jax_params(net, params, layout="NHWC")
    net.save_parameters(tmp + "/net.params")
    net.hybridize(aot=tmp + "/net.aot")
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9})
    first = step.step(x, y).item()
    step.save_executable(tmp + "/step.aot")
    step.save_states(tmp + "/step.st")
    # the running statistics (the states file holds the parameters)
    net.save_parameters(tmp + "/step.params")
    second = step.step(x, y).item()
    np.save(tmp + "/out.npy", out.numpy())
    np.save(tmp + "/losses.npy", np.array([first, second]))
    print("EXPORTED", cc.stats()["aot_saves"])
else:
    net.load_parameters(tmp + "/net.params")
    net.hybridize(aot=tmp + "/net.aot")
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert np.array_equal(out.numpy(), np.load(tmp + "/out.npy"))
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9})
    net.load_parameters(tmp + "/step.params")
    before = [t.detach().clone() for t in net.state_dict().values()]
    step.load_executable(tmp + "/step.aot", x, y)
    assert all(torch.equal(a, b) for a, b in zip(
        before, net.state_dict().values()))
    step.load_states(tmp + "/step.st")
    second = step.step(x, y).item()
    assert second == np.load(tmp + "/losses.npy")[1], second
    try:
        step.load_executable(tmp + "/step.aot", x[:1], y[:1])
    except tmx.MXNetError:
        print("LOADED", cc.stats()["aot_loads"], net.stats()["captures"],
              out.numpy().tobytes().hex()[:16])
"""


def test_fresh_process_round_trip_matches_the_exporter_and_jax(tmp_path):
    """A small channels-last DenseNet with the JAX package's weights:
    the exporting process writes ``.params``, the block's bundle and
    the step's (with ``save_states``, and ``save_parameters`` for the
    running statistics, which BatchNorm's shifted one-pass statistics
    read); a fresh process reads them and its hybridized output and
    next train step equal the exporter's bitwise (no capture on the
    CPU); the exporter's output and first loss agree with the JAX
    package's own, computed here."""
    mx.random.seed(3)
    jnet = jvision.DenseNet(16, 8, [2, 2], classes=10, layout="NHWC")
    jnet.initialize(mx.init.Xavier())
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 3, 56, 56)).astype(np.float32)
    y = np.array([3.0, 7.0], np.float32)
    with autograd.predict_mode():
        want = jnet(nd.array(x)).asnumpy()
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    with autograd.record():
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(nd.array(x)), nd.array(y)).mean()
    np.savez(str(tmp_path / "ref.npz"), x=x, y=y,
             **{"p:" + k: v for k, v in params.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = []
    for phase in ("export", "load"):
        r = subprocess.run([sys.executable, "-c", _FRESH, phase,
                            str(tmp_path)], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.split())
    assert outs[0][0] == "EXPORTED" and int(outs[0][1]) == 2
    assert outs[1][:3] == ["LOADED", "0", "0"]
    got = np.load(str(tmp_path / "out.npy"))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    losses = np.load(str(tmp_path / "losses.npy"))
    np.testing.assert_allclose(losses[0], float(jloss.asscalar()),
                               rtol=1e-5)
    assert losses[1] < losses[0]
