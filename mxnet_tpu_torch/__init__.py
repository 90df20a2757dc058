"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu``.

The JAX package stays the reference; this package mirrors its paths and
public names and imports neither JAX nor anything of ``mxnet_tpu``.
Ported so far:

* the Llama serving tier (``serve``) with the paged-attention kernel
  (``ops.paged_attention``, K4);
* Llama training (``gluon``, ``initializer``, ``optimizer``,
  ``parallel.JitTrainStep``) with the flash-attention forward and
  backward kernels (``ops.flash_attention``, K1–K3);
* MXNet's imperative frontend: ``nd`` (NDArray on a ``Context`` and the
  ops of ``ops/tensor.py``), the dependency ``engine`` over CUDA
  streams, the ``autograd`` tape over torch's autograd, and ``rtc``
  (K5: user CUDA C++ compiled by NVRTC and launched on NDArrays, and
  the interpreted ``PallasKernel``);
* the compiled paths: ``graph_cache`` captures one CUDA graph per call
  signature, the counterpart of the JAX package's one executable per
  signature, for the serve runner's steps and ``HybridBlock.hybridize()``;
* ResNet: the convolution, pooling, BatchNorm and activation layers
  (``gluon.nn`` over ``ops.nn``), ``gluon.model_zoo.vision``'s ResNets,
  ``amp`` and the ``layout`` policy (channels-last on the card);
* the optimizer tier: every optimizer of the registry, ``Updater``,
  ``lr_scheduler``, the update ops of ``ops.optimizer_ops`` with the
  multi-tensor kernels O1-O3 (Adam/AdamW, SGD, sum of squares), and
  ``Trainer.save_states`` in the MXGC1 format (``sharding.checkpoint``);
* BERT: ``gluon.model_zoo.bert`` (self-attention through K1-K3, the
  exact-GELU FFN, the tied MLM head), the norms and containers of
  ``gluon.nn`` (``LayerNorm``, ``GroupNorm``, ``InstanceNorm``,
  ``Concurrent``, ``Lambda``, ...) and ``JitTrainStep.save_states``;
* Gluon's parameter layer (``gluon.Parameter``, ``ParameterDict``,
  ``collect_params()`` under the JAX package's names, ``grad_req``,
  ``save_parameters``/``load_parameters`` over ``nd.save``'s ``.params``
  files), NDArrays through Gluon blocks, ``gluon.data`` (datasets,
  samplers, ``DataLoader``, vision transforms), ``gluon.utils`` and
  ``metric``;
* DCGAN's layers and the op tail: ``Deconvolution`` and the transposed
  convolution layers, ``ReflectionPad2D``, ``mx.random`` and
  ``nd.random`` over the samplers of ``ops.random_ops``, and the rest of
  the JAX package's ``ops/nn.py`` and ``ops/tensor.py``;
* the detection, contrib and misc op tail (``ops.vision``, ``ops.contrib``
  with O4, the NMS kernel, ``ops.misc``), control flow
  (``nd.contrib.foreach``/``while_loop``/``cond``), ``mx.operator``'s
  CustomOp, and ``hybrid_forward(F, ...)`` blocks;
* int8 quantization: the quantized ops (``ops.quantized_ops``) and
  ``contrib.quantization`` (``quantize_net_v2``), whose products run on
  the int8 kernels O5 and O6 (``ops.int8_ops``);
* the NumPy frontend: ``mx.np`` (``numpy``: the NumPy-semantics
  ``ndarray`` over NDArray, its function namespace, ``np.linalg`` and
  ``np.random``), ``mx.npx`` (``numpy_extension``), the ``_np*``/
  ``_npi_*`` ops of ``ops.npi`` and ``mx.util``;
* sparse storage: ``nd.sparse`` (``RowSparseNDArray``, ``CSRNDArray``),
  ``Embedding(sparse_grad=True)`` with the lazy row-sparse update, the
  sparse dot and the lazy update as the kernels O7 and O8
  (``ops.sparse_ops``), dlpack, ``gluon.contrib.nn`` and ``io`` with
  ``LibSVMIter``;
* the telemetry and testing modules these tiers use.

The port's own kernels are CUDA C++ for sm_90a in ``csrc/``.  Entry
points run on the card (``cuda:0``, ``gpu(0)``) unless asked for the
host with ``device="cpu"``, ``ctx=mx.cpu()`` or ``with mx.cpu():``.
"""
from . import amp, base, context, layout, ops, serve  # noqa: F401
from . import telemetry, testing  # noqa: F401
from . import gluon, initializer, optimizer, parallel  # noqa: F401
from . import lr_scheduler, sharding  # noqa: F401
from . import metric, name, registry  # noqa: F401
from . import autograd, engine, ndarray, random, rtc  # noqa: F401
from . import operator  # noqa: F401
from . import contrib  # noqa: F401
from . import io  # noqa: F401
from . import numpy, numpy_extension, util  # noqa: F401
from . import numpy as np  # noqa: F401
from . import numpy_extension as npx  # noqa: F401
from .numpy_extension import (is_np_array, is_np_shape,  # noqa: F401
                              reset_np, set_np)
from . import initializer as init  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import (Context, cpu, cpu_pinned,  # noqa: F401
                      current_context, gpu, num_gpus)
from .engine import waitall  # noqa: F401
from .layout import layout_scope, set_default_layout  # noqa: F401
from .ndarray import NDArray  # noqa: F401

__version__ = "0.1.0"
