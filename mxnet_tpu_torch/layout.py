"""The spatial-layout policy (the port's counterpart of
``mxnet_tpu/layout.py``): channels-last on the card, NCHW for parity.

The policy is the JAX package's, with its two tiers:

- **Bare gluon layers** (``nn.Conv2D``, pooling, ``nn.BatchNorm`` built
  with no ``layout=``/``axis=``) resolve through :func:`default_layout`,
  which under the default ``"auto"`` policy is always channel-first: user
  code feeding NCHW batches keeps working on every device.  Channels-last
  for bare layers is asked for with :class:`layout_scope` or ``layout=``.
- **Model-zoo networks** resolve through :func:`preferred_layout`, which
  under ``"auto"`` picks channels-last iff the net lives on a CUDA device
  (the JAX package asks JAX for its backend).  The nets accept NCHW
  batches and change layout once at the stem.

What channels-last means here: a layer built with ``layout="NHWC"``
takes and returns NHWC tensors, as the JAX package's does, and stores
its convolution weight as OIHW in ``torch.channels_last`` memory.  An
NHWC tensor with contiguous memory permuted to NCHW is a channels-last
view of the same memory, so the layer hands cuDNN channels-last
operands and permutes back without a copy, and the stem's transpose is
a change of memory format.

Layout is resolved when a layer is built; changing the policy later
never re-lays-out live parameters.
"""
from __future__ import annotations

import threading

import torch

_CHANNEL_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_CHANNEL_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
_VALID = ({"auto", "channel_first", "channel_last"}
          | set(_CHANNEL_FIRST.values()) | set(_CHANNEL_LAST.values()))

_process_policy = ["auto"]
_state = threading.local()


def _auto_channel_last(device=None):
    """True iff ``device`` is a CUDA device (``None``: the port's
    default device, the card)."""
    return device is None or torch.device(device).type == "cuda"


def _canonical(policy):
    if policy in _CHANNEL_LAST.values() or policy == "channel_last":
        return "channel_last"
    if policy in _CHANNEL_FIRST.values() or policy == "channel_first":
        return "channel_first"
    return "auto"


def _check(policy):
    if policy not in _VALID:
        raise ValueError("unknown layout policy %r (want one of %s)"
                         % (policy, sorted(_VALID)))


def get_policy():
    """Active policy: the thread's scope override, else the process base."""
    return getattr(_state, "policy", None) or _process_policy[0]


def set_default_layout(policy):
    """Set the process-wide base policy; returns the previous one."""
    _check(policy)
    prev = _process_policy[0]
    _process_policy[0] = _canonical(policy)
    return prev


class layout_scope:
    """``with layout_scope("NHWC"): net = resnet50_v1()``: a
    thread-local policy override."""

    def __init__(self, policy):
        _check(policy)
        self._policy = _canonical(policy)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_state, "policy", None)
        _state.policy = self._policy
        return self

    def __exit__(self, *exc):
        _state.policy = self._prev
        return False


def is_channel_last():
    """True iff bare layers build channels-last now (an explicit
    channel_last policy only)."""
    return _canonical(get_policy()) == "channel_last"


def default_layout(ndim=2):
    """The layout a bare spatial layer picks when the caller does not
    say: channel-first under ``auto``."""
    table = _CHANNEL_LAST if is_channel_last() else _CHANNEL_FIRST
    return table[ndim]


def preferred_layout(ndim=2, device=None):
    """The layout a model-zoo net built on ``device`` picks:
    channels-last under ``auto`` iff the device is a CUDA device."""
    c = _canonical(get_policy())
    last = _auto_channel_last(device) if c == "auto" \
        else c == "channel_last"
    return (_CHANNEL_LAST if last else _CHANNEL_FIRST)[ndim]


def channel_axis(layout):
    """Channel axis index for a layout string (1 or -1)."""
    return 1 if layout.startswith("NC") else -1


def current_channel_axis():
    """Channel axis implied for bare layers by the active policy."""
    return -1 if is_channel_last() else 1
