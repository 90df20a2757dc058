"""Host side of the port's serving tier: the copied scheduler over the
port's torch arena, the port bundle, device resolution, and the import
rule (the port reaches neither JAX nor the JAX package).

Scheduler cases drive ``step()`` on the calling thread with a scripted
runner and a counter clock, as the JAX package's own serve tests do.
"""
import ast
import gc
import itertools
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import context, serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import (KVGeometry, LlamaServer, PagedKVArena,
                                   Request, Scheduler, ServeCancelled,
                                   ServeDeadlineExceeded, TorchRunner)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_geometry(**over):
    kw = dict(num_layers=1, num_heads=2, num_kv_heads=1, head_dim=4,
              units=8, hidden_size=16, vocab_size=32, page_size=4,
              num_pages=9, max_pages_per_seq=4, max_batch=2,
              prefill_buckets=(4, 8))
    kw.update(over)
    return KVGeometry(**kw)


def counter_clock(step=0.01):
    c = itertools.count()
    return lambda: next(c) * step


class ScriptedRunner:
    """Position-indexed ground truth: the model's output after the token
    at stream position p is ``seq[p + 1]`` (one-hot logits), however the
    positions are grouped into prefill/decode/verify calls."""

    def __init__(self, geometry, seq):
        self.g = geometry
        self.seq = seq
        self.prefills, self.decodes, self.verifies = [], [], []

    def _onehot(self, tok):
        v = np.zeros(self.g.vocab_size, np.float32)
        v[int(tok)] = 1.0
        return v

    def prefill(self, bucket, tokens, length, block_row):
        self.prefills.append((bucket, int(length), np.array(block_row)))
        return self._onehot(self.seq[int(length)])

    def decode(self, tokens, positions, block_tables):
        self.decodes.append((np.array(positions), np.array(block_tables)))
        return np.stack([self._onehot(self.seq[int(p) + 1])
                         for p in positions])

    def verify(self, tokens, positions, block_tables):
        self.verifies.append(np.array(positions))
        k1 = tokens.shape[1]
        return np.stack([np.stack([self._onehot(self.seq[int(p) + j + 1])
                                   for j in range(k1)]) for p in positions])


SEQ = [5, 6, 7] * 40


def make_sched(g=None, seq=SEQ, **kw):
    g = g or tiny_geometry()
    arena = PagedKVArena(g, device="cpu")
    runner = ScriptedRunner(g, seq)
    sched = Scheduler(runner, arena, queue_depth=8, clock=counter_clock(),
                      **kw)
    return sched, runner, arena


def run_to_completion(sched, max_steps=10_000):
    steps = 0
    while sched.has_work():
        sched.step()
        steps += 1
        assert steps < max_steps, "scheduler failed to drain"
    return steps


def test_admission_waits_for_pages_and_recycles_slots():
    g = tiny_geometry(num_pages=5, max_batch=1)        # 4 free pages
    sched, runner, arena = make_sched(g)
    big = sched.submit(Request(SEQ[:4], max_new_tokens=12))     # 4 pages
    small = sched.submit(Request(SEQ[:1], max_new_tokens=3))    # 1 page
    sched.step()
    assert sched.active_slots() == 1 and sched.queue_len() == 1
    assert arena.free_pages == 0
    run_to_completion(sched)
    assert big.result(timeout=0) == SEQ[4:16]
    assert small.result(timeout=0) == SEQ[1:4]
    # the second request reused the freed lane and pages
    assert [p[0] for p in runner.prefills] == [4, 4]
    arena.assert_quiescent()


def test_inactive_lane_rides_the_null_page():
    sched, runner, arena = make_sched()
    sched.submit(Request(SEQ[:2], max_new_tokens=3))
    run_to_completion(sched)
    positions, tables = runner.decodes[0]
    assert positions[1] == 0 and not tables[1].any()
    arena.assert_quiescent()


def test_spec_acceptance_matches_plain_decode():
    outs = {}
    for spec_k in (0, 2):
        g = tiny_geometry(spec_k=2, num_pages=12, max_pages_per_seq=8)
        sched, runner, arena = make_sched(g, spec_k=spec_k)
        req = sched.submit(Request(SEQ[:4], max_new_tokens=10))
        run_to_completion(sched)
        outs[spec_k] = req.result(timeout=0)
        if spec_k:
            assert sched.spec_accepted > 0
            assert len(runner.verifies) < 9, "blocks were accepted"
        arena.assert_quiescent()
    assert outs[0] == outs[2] == SEQ[4:14]


def test_deadline_mid_decode_frees_pages():
    sched, _, arena = make_sched()
    req = sched.submit(Request(SEQ[:2], max_new_tokens=14, deadline_s=0.2))
    sched.step()
    assert sched.active_slots() == 1
    for _ in range(200):
        if req.done():
            break
        sched.step()
    with pytest.raises(ServeDeadlineExceeded):
        req.result(timeout=0)
    assert sched.active_slots() == 0
    arena.assert_quiescent()


def test_cancel_in_flight_frees_pages():
    sched, _, arena = make_sched()
    req = sched.submit(Request(SEQ[:2], max_new_tokens=10))
    sched.step()
    assert arena.free_pages < arena.total_pages
    req.cancel()
    sched.step()
    with pytest.raises(ServeCancelled):
        req.result(timeout=0)
    arena.assert_quiescent()


def test_assert_quiescent_names_the_leak_and_reset_zeroes():
    g = tiny_geometry(kv_dtype="int8")
    arena = PagedKVArena(g, device="cpu")
    assert arena.kv_k.dtype == torch.int8 and arena.k_scale.shape == (1, 9)
    pages = arena.alloc(2, owner="req-7")
    with pytest.raises(MXNetError, match="req-7"):
        arena.assert_quiescent()
    with pytest.raises(MXNetError, match="live page"):
        arena.reset()
    arena.kv_k.fill_(3)
    arena.k_scale.fill_(0.5)
    arena.free(pages, owner="req-7")
    arena.reset()
    arena.assert_quiescent()
    assert not arena.kv_k.any() and not arena.k_scale.any()
    with pytest.raises(MXNetError, match="scale"):
        arena.adopt(arena.kv_k, arena.kv_v)


def test_arena_refcounts_shared_pages():
    arena = PagedKVArena(tiny_geometry(), device="cpu")
    pages = arena.alloc(2, owner="a")
    assert 0 not in pages
    arena.retain(pages, owner="cache")
    arena.free(pages, owner="a")
    assert arena.refcount(pages[0]) == 1 and arena.shared_pages() == 0
    with pytest.raises(MXNetError, match="double free"):
        arena.free(pages, owner="a")
    arena.free(pages, owner="cache")
    arena.assert_quiescent()


def test_healthz_accounts_weights_and_arena_by_origin():
    from mxnet_tpu_torch.telemetry import memdump

    g = tiny_geometry(kv_dtype="int8")
    arena = PagedKVArena(g, device="cpu")
    w = serve.init_weights(g, seed=1, device="cpu")
    with LlamaServer.from_parts(TorchRunner(w, arena), arena) as srv:
        srv.generate([1, 2, 3], max_new_tokens=2)
        hz = srv.healthz()
    by = hz["device_bytes_by_origin"]
    assert by["kv_page"] >= sum(t.numel() * t.element_size()
                                for t in arena.buffers())
    assert by["param"] >= sum(t.numel() * t.element_size()
                              for t in [w[0], w[2]] + [
                                  v for lw in w[1] for v in lw.values()])
    assert hz["live_device_bytes"] >= by["kv_page"] + by["param"]
    assert memdump.peak_bytes() >= hz["live_device_bytes"]
    # a tag dies with its tensor
    before = memdump.refresh()[0]["kv_page"]
    del srv, arena
    gc.collect()
    assert memdump.refresh()[0]["kv_page"] < before


_GC_IN_LOCKED_SECTION = r"""
import gc
import torch
from mxnet_tpu_torch.telemetry import memdump

class Node:
    pass

gc.disable()
for _ in range(64):       # tagged tensors that only a collection frees
    n = Node()
    n.cycle, n.t = n, torch.zeros(4)
    memdump.tag(n.t, origin="param")
    del n
gc.set_threshold(1)       # the next allocation collects ...
gc.enable()
live = memdump._live_tags()  # ... inside memdump's locked tag walk
by, _ = memdump.refresh()
print("REFRESHED", len(live), by["param"])
"""


def test_memdump_survives_a_collection_inside_its_lock():
    """A tagged tensor's finalizer can run inside a garbage collection
    that an allocation starts while memdump holds its lock; it must not
    wait on that lock (the finalizer once did, and the process hung)."""
    r = subprocess.run([sys.executable, "-c", _GC_IN_LOCKED_SECTION],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["REFRESHED", "0", "0"], r.stdout


@pytest.mark.cuda
def test_two_servers_in_one_process_on_the_card():
    """Two ``from_parts`` servers (a fleet's replicas) serve from their
    own loop threads in one process on the card: each gives the tokens
    it gives alone, K4 runs for both, and stopping them frees both
    arenas and both sets of weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the serve path launches the "
                    "CUDA paged-attention kernel, which has no CPU mode")
    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    g = tiny_geometry(num_layers=2, num_heads=4, num_kv_heads=2,
                      head_dim=16, units=64, hidden_size=128,
                      vocab_size=64, num_pages=32, max_pages_per_seq=8,
                      prefill_buckets=(8, 16))
    prompts = [[3, 1, 4], [5, 9, 2, 6, 5], list(range(1, 12))]
    servers, refs = [], []
    for seed in (0, 1):
        arena = PagedKVArena(g)
        w = serve.init_weights(g, seed=seed, std=0.5)
        refs += [weakref.ref(t) for t in arena.buffers()]
        refs += [weakref.ref(t) for t in [w[0], w[2]]
                 + [v for lw in w[1] for v in lw.values()]]
        servers.append(LlamaServer.from_parts(TorchRunner(w, arena), arena))
    del arena, w
    alone = []
    for srv in servers:
        with srv:
            alone.append([srv.generate(p, max_new_tokens=6, timeout=120)
                          for p in prompts])
    for srv in servers:
        srv.start()
    steps = -sum(srv.stats()["decode_steps"] for srv in servers)
    before = paged_attention.launches
    futs = [[srv.submit(p, max_new_tokens=6) for p in prompts]
            for srv in servers]
    both = [[f.result(timeout=120) for f in fs] for fs in futs]
    steps += sum(srv.stats()["decode_steps"] for srv in servers)
    assert paged_attention.launches - before >= steps * g.num_layers > 0
    assert both == alone
    for srv in servers:
        srv.drain(timeout=60)
        srv.stop()
        srv.arena.assert_quiescent()
    del servers, srv
    gc.collect()
    # every arena page and weight of both replicas is gone (the card's
    # allocated total is no measure: each loop thread got its own cuBLAS
    # workspace, which torch keeps)
    assert refs and all(r() is None for r in refs)


def test_bundle_round_trip_serves_identical_tokens(tmp_path):
    g = tiny_geometry(num_layers=2, num_pages=16, max_pages_per_seq=6,
                      spec_k=2)
    w = serve.init_weights(g, seed=4, std=0.5, device="cpu")
    raw = (w[0].numpy(), [{k: v.numpy() for k, v in lw.items()}
                          for lw in w[1]], w[2].numpy(),
           None if w[3] is None else w[3].numpy())
    path = str(tmp_path / "tiny.npz")
    serve.save_serving_bundle(path, raw, g)
    g2, raw2 = serve.load_serving_bundle(path)
    assert g2.to_dict() == g.to_dict()
    for a, b in zip((raw[0], raw[2]), (raw2[0], raw2[2])):
        assert np.array_equal(a, b)

    arena = PagedKVArena(g, device="cpu")
    direct = LlamaServer.from_parts(TorchRunner(w, arena), arena)
    with direct:
        want = direct.generate([3, 1, 4], max_new_tokens=5)
    with LlamaServer(path, device="cpu") as srv:
        assert srv.bundle_sha and srv.geometry.spec_k == 2
        assert srv.generate([3, 1, 4], max_new_tokens=5) == want
        srv.reload(path, timeout=60)
        assert srv.generate([3, 1, 4], max_new_tokens=5) == want
    srv.arena.assert_quiescent()
    # geometry pins are checked at load, naming the field
    with pytest.raises(MXNetError, match="page_size"):
        LlamaServer(path, expect_geometry={"page_size": 8}, device="cpu")
    with pytest.raises(MXNetError, match="not a port serving bundle"):
        np.savez(str(tmp_path / "other.npz"), x=np.zeros(2))
        serve.load_serving_bundle(str(tmp_path / "other.npz"))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        assert context.resolve(None) == torch.device("cuda", 0)
        return
    with pytest.raises(MXNetError, match="CUDA is not available"):
        context.gpu()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        PagedKVArena(tiny_geometry())
    with pytest.raises(MXNetError, match="CUDA is not available"):
        serve.init_weights(tiny_geometry())
    assert context.resolve("cpu") == torch.device("cpu")
    assert context.cpu() == torch.device("cpu")


def test_train_entry_points_default_to_cuda_and_raise_without_it():
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon.model_zoo import bert, llama
    from mxnet_tpu_torch.ops import flash_attention as fa

    if torch.cuda.is_available():
        net = llama.llama_small()
        assert next(net.parameters()).device == torch.device("cuda", 0)
        return
    # the model, its layers and so every JitTrainStep over them are
    # made on cuda:0 unless asked otherwise
    for make in (llama.llama3_8b, llama.llama_small,
                 lambda: llama.LlamaModel(32, units=8, hidden_size=16,
                                          num_layers=1, num_heads=2),
                 lambda: gluon.nn.Dense(4, in_units=4),
                 lambda: gluon.nn.Embedding(4, 4), bert.bert_small,
                 lambda: gluon.nn.LayerNorm(in_channels=4)):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
    net = llama.llama_small(num_layers=1, device="cpu")
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adamw")
    step.step(np.zeros((1, 4), np.int32), np.zeros((1, 4), np.float32))
    assert step._params[0].device == torch.device("cpu")
    # the flash op runs its kernels on CUDA tensors, its plain versions
    # on CPU tensors, and nothing else
    meta = torch.empty((1, 1, 4, 8), device="meta")
    with pytest.raises(MXNetError, match="cuda or cpu"):
        fa.flash_attention(meta, meta, meta)
    with pytest.raises(MXNetError):
        fa._fwd_kernel(*(torch.zeros(1, 4, 8, dtype=torch.float16),) * 3,
                       0.5, True)


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("blocked import of %s" % name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
        del sys.modules[name]
sys.modules["jax"] = None
sys.modules["mxnet_tpu"] = None
sys.meta_path.insert(0, Block())

def mapped(stem):
    with open("/proc/self/maps") as f:
        return stem in f.read()

# importing the package maps neither libnvrtc nor libcuda beyond what
# importing torch maps (a CUDA build of torch maps both itself)
import torch
torch_libs = (mapped("libnvrtc"), mapped("libcuda.so"))
import mxnet_tpu_torch
print("LIBS", mapped("libnvrtc") and not torch_libs[0],
      mapped("libcuda.so") and not torch_libs[1])
names = [m.name for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                               "mxnet_tpu_torch.")]
names += ["mxnet_tpu_torch.nd", "mxnet_tpu_torch.ndarray.ndarray",
          "mxnet_tpu_torch.autograd", "mxnet_tpu_torch.engine",
          "mxnet_tpu_torch.rtc", "mxnet_tpu_torch.ops._nvrtc"]
names += ["mxnet_tpu_torch.serve.fleet", "mxnet_tpu_torch.serve.__main__",
          "mxnet_tpu_torch.telemetry.aggregate",
          "mxnet_tpu_torch.telemetry.slo", "mxnet_tpu_torch.telemetry.trace"]
names += ["mxnet_tpu_torch.layout", "mxnet_tpu_torch.amp",
          "mxnet_tpu_torch.amp.lists", "mxnet_tpu_torch.amp.loss_scaler",
          "mxnet_tpu_torch.ops.nn", "mxnet_tpu_torch.gluon.nn.conv_layers",
          "mxnet_tpu_torch.gluon.nn.activations",
          "mxnet_tpu_torch.gluon.model_zoo.vision",
          "mxnet_tpu_torch.gluon.model_zoo.vision.resnet"]
names += ["mxnet_tpu_torch.lr_scheduler", "mxnet_tpu_torch.sharding",
          "mxnet_tpu_torch.sharding.checkpoint",
          "mxnet_tpu_torch.ops.optimizer_ops",
          "mxnet_tpu_torch.optimizer.optimizer"]
names += ["mxnet_tpu_torch.gluon.parameter", "mxnet_tpu_torch.gluon.utils",
          "mxnet_tpu_torch.gluon.data", "mxnet_tpu_torch.gluon.data.dataset",
          "mxnet_tpu_torch.gluon.data.sampler",
          "mxnet_tpu_torch.gluon.data.dataloader",
          "mxnet_tpu_torch.gluon.data.vision.datasets",
          "mxnet_tpu_torch.gluon.data.vision.transforms",
          "mxnet_tpu_torch.ndarray.legacy_io", "mxnet_tpu_torch.metric",
          "mxnet_tpu_torch.registry", "mxnet_tpu_torch.name"]
names += ["mxnet_tpu_torch.compile_cache", "mxnet_tpu_torch.gluon.loss",
          "mxnet_tpu_torch.initializer"] + [
          "mxnet_tpu_torch.gluon.model_zoo.vision." + m
          for m in ("alexnet", "vgg", "squeezenet", "densenet", "inception",
                    "mobilenet", "_base")]
names += ["mxnet_tpu_torch.random", "mxnet_tpu_torch.ndarray.random",
          "mxnet_tpu_torch.ops.random_ops", "mxnet_tpu_torch.ops.tensor",
          "mxnet_tpu_torch.gluon.nn.basic_layers"]
names += ["mxnet_tpu_torch.ops.contrib", "mxnet_tpu_torch.ops.box_nms",
          "mxnet_tpu_torch.ops.vision", "mxnet_tpu_torch.ops.misc",
          "mxnet_tpu_torch.ops.control_flow", "mxnet_tpu_torch.operator",
          "mxnet_tpu_torch.gluon.block"]
names += ["mxnet_tpu_torch.ops.quantized_ops", "mxnet_tpu_torch.ops.int8_ops",
          "mxnet_tpu_torch.contrib", "mxnet_tpu_torch.contrib.quantization"]
names += ["mxnet_tpu_torch.ops.npi", "mxnet_tpu_torch.numpy",
          "mxnet_tpu_torch.numpy.linalg", "mxnet_tpu_torch.numpy.random",
          "mxnet_tpu_torch.numpy_extension", "mxnet_tpu_torch.util"]
names += ["chip_smoke", "tools.torch_paged_attention_sweep",
          "tools.torch_flash_attention_sweep", "tools.torch_mxfleet",
          "tools.torch_mxflight", "tools.torch_mxtrace",
          "tools.torch_resnet_trajectory"]
for name in names:
    importlib.import_module(name) if name != "mxnet_tpu_torch.nd" \
        else mxnet_tpu_torch.nd
from mxnet_tpu_torch.ops import _nvrtc
print("LIBS", mapped("libnvrtc") and not torch_libs[0],
      mapped("libcuda.so") and not torch_libs[1],
      _nvrtc._nvrtc is None and _nvrtc._cuda is None)
bad = sorted(n for n in sys.modules if n.split(".")[0] in
             ("jax", "jaxlib", "mxnet_tpu") and sys.modules[n] is not None)
print("IMPORTED", len(names), "BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "LIBS False False", lines
    assert lines[-2] == "LIBS False False True", lines
    line = lines[-1]
    assert line.endswith("BAD []"), line
    assert int(line.split()[1]) >= 30, line
    # imports inside functions run only on the card: check them by source
    files = [os.path.join(d, f) for d, _, fs in
             os.walk(os.path.join(REPO, "mxnet_tpu_torch")) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", "torch_%s.py" % t)
              for t in ("paged_attention_sweep", "flash_attention_sweep",
                        "mxfleet", "mxflight", "mxtrace",
                        "resnet_trajectory")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "mxnet_tpu"), (path, m)


def test_http_front_serves_generate_and_healthz():
    g = tiny_geometry(num_layers=2)
    arena = PagedKVArena(g, device="cpu")
    w = serve.init_weights(g, seed=3, std=0.5, device="cpu")
    with LlamaServer.from_parts(TorchRunner(w, arena), arena) as srv:
        want = srv.generate([3, 1, 4], max_new_tokens=3)
        host, port = srv.serve_http(port=0)
        base = "http://%s:%d" % (host, port)
        body = json.dumps({"prompt": [3, 1, 4],
                           "max_new_tokens": 3}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/v1/generate", data=body), timeout=60) as r:
            doc = json.loads(r.read())
        assert doc["tokens"] == want and doc["trace_id"]
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            hz = json.loads(r.read())
        assert hz["ok"] is True and hz["completed"] >= 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                base + "/v1/generate", data=b"{}"), timeout=60)
        assert ei.value.code == 400
    arena.assert_quiescent()
