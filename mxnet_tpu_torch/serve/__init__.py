"""Llama serving on PyTorch: the port of ``mxnet_tpu.serve``.

- :mod:`.scheduler` — continuous batching over a runner interface
  (copied from the JAX package as it is, with :mod:`.spec` and
  :mod:`.prefix`);
- :mod:`.arena` — the paged KV arena on torch tensors;
- :mod:`.model` — the prefill/decode/verify/chunk steps as torch
  functions, attending through the paged-attention kernel on CUDA;
- :mod:`.server` — :class:`TorchRunner` (on the card, each step
  signature a captured CUDA graph) and :class:`LlamaServer` with its
  HTTP front;
- :mod:`.fleet` — :class:`FleetRouter`, a queue-aware front over N
  replicas (copied from the JAX package as it is): power-of-two-choices
  routing, bounded retries and hedging, circuit-breaker ejection and
  rolling deploys; ``python -m mxnet_tpu_torch.serve --fleet N`` starts
  one from the command line.

Quick start (``device`` defaults to ``cuda:0``)::

    from mxnet_tpu_torch import serve

    g = serve.KVGeometry(num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, units=64, hidden_size=128,
                         vocab_size=512, page_size=8, num_pages=64,
                         max_pages_per_seq=8, max_batch=4,
                         prefill_buckets=(16, 32))
    arena = serve.PagedKVArena(g)
    runner = serve.TorchRunner(serve.init_weights(g, seed=0), arena)
    with serve.LlamaServer.from_parts(runner, arena) as srv:
        tokens = srv.generate([1, 2, 3], max_new_tokens=16)
"""
from .arena import PagedKVArena
from .fleet import (FleetNoHealthyReplica, FleetRouter, HttpReplica,
                    LocalReplica, fleet_drive_workload)
from .model import (KVGeometry, build_decode_fn, build_prefill_fn,
                    build_step_fn, build_verify_fn, check_geometry,
                    convert_weights, default_buckets, extract_weights,
                    init_weights, load_serving_bundle, save_serving_bundle)
from .prefix import PrefixCache
from .scheduler import (Request, Scheduler, ServeCancelled,
                        ServeDeadlineExceeded, ServeDraining,
                        ServeInternalError, ServeQueueFull,
                        ServeSessionBusy, ServeSessionUnknown, ServeShutdown,
                        clamp_retry_after, greedy_sampler)
from .server import (LlamaServer, TorchRunner, drive_workload,
                     poisson_workload)
from .spec import NgramProposer, propose_ngram

__all__ = [
    "FleetNoHealthyReplica", "FleetRouter", "HttpReplica", "KVGeometry",
    "LlamaServer", "LocalReplica", "NgramProposer", "PagedKVArena",
    "PrefixCache", "Request", "Scheduler", "ServeCancelled",
    "ServeDeadlineExceeded", "ServeDraining", "ServeInternalError",
    "ServeQueueFull", "ServeSessionBusy", "ServeSessionUnknown",
    "ServeShutdown", "TorchRunner", "build_decode_fn", "build_prefill_fn",
    "build_step_fn", "build_verify_fn", "check_geometry",
    "clamp_retry_after", "convert_weights", "default_buckets",
    "drive_workload", "extract_weights", "fleet_drive_workload",
    "greedy_sampler", "init_weights",
    "load_serving_bundle", "poisson_workload", "propose_ngram",
    "save_serving_bundle",
]
