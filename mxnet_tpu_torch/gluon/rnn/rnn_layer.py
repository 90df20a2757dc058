"""Fused recurrent layers (the port's counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``; parity:
``python/mxnet/gluon/rnn/rnn_layer.py``).

``RNN``/``LSTM``/``GRU`` keep the JAX package's per-layer and direction
parameters, ``{l,r}{i}_{i2h,h2h}_{weight,bias}``, and run the whole
multi-layer recurrence through the ``RNN`` op's function
(``ops.nn.rnn_fused``: torch's fused recurrence, cuDNN on the card).
The layer hands its parameters to that function as they are, a layer
and direction at a time, where the JAX package concatenates them into
the op's packed vector every call; the two give the same result
(``tests/test_torch_rnn.py``).  Dropout between layers goes through the
port's ``Dropout`` and torch's generators, never cuDNN's own.

``layer(inputs)`` returns the output; ``layer(inputs, states)`` returns
``(output, new_states)``, as in the JAX package.  A hybridized layer's
calls are captured CUDA graphs (or graph pairs under
``autograd.record()``), cuDNN's RNN kernels inside them.
"""
from __future__ import annotations

import torch

from ... import amp as _amp
from ... import autograd as _autograd
from ... import ndarray as nd_mod
from ...base import MXNetError
from ...ops.nn import _gates, rnn_fused
from ..block import HybridBlock, _LAZY

__all__ = ['RNN', 'LSTM', 'GRU']


class _RNNLayer(HybridBlock):
    """Base fused layer (parity: rnn_layer.py:34)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 prefix=None, params=None):
        self._mode = mode  # before super().__init__: _alias() needs it
        super().__init__(prefix=prefix, params=params)
        assert layout in ('TNC', 'NTC'), \
            "Invalid layout %s; must be one of ['TNC', 'NTC']" % layout
        if projection_size:
            raise MXNetError("projection_size (LSTMP) is not supported")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _gates(mode)

        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ['l', 'r'][:self._dir]:
                    for name, shape, init in [
                            ('i2h_weight', (ng * nh, ni),
                             i2h_weight_initializer),
                            ('h2h_weight', (ng * nh, nh),
                             h2h_weight_initializer),
                            ('i2h_bias', (ng * nh,), i2h_bias_initializer),
                            ('h2h_bias', (ng * nh,), h2h_bias_initializer)]:
                        pname = '%s%d_%s' % (j, i, name)
                        setattr(self, pname, self.params.get(
                            pname, shape=shape, init=init,
                            allow_deferred_init=True))
                ni = nh * self._dir

    def __repr__(self):
        s = '{name}({mapping}, {_layout}'
        if self._num_layers != 1:
            s += ', num_layers={_num_layers}'
        if self._dropout != 0:
            s += ', dropout={_dropout}'
        if self._dir == 2:
            s += ', bidirectional'
        s += ')'
        w = self.l0_i2h_weight
        shape = None if isinstance(w, _LAZY) else tuple(w.shape)
        mapping = '%s -> %s' % (shape[1] if shape else None,
                                self._hidden_size)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def _alias(self):
        return self._mode

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial recurrent states for a batch (zeros by default)."""
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            info.update(kwargs)
            shape = info.pop('shape')
            info.pop('__layout__', None)
            states.append(func(shape, **info))
        return states

    def _ordered_param_names(self):
        """Registered param names in the packed-vector layout the RNN op
        expects (``ops.nn._unpack_rnn_params``; reference rnn-inl.h): all
        weights per layer/direction (W_x then W_h), then all biases."""
        weights, biases = [], []
        for i in range(self._num_layers):
            for j in ['l', 'r'][:self._dir]:
                weights.append('%s%d_i2h_weight' % (j, i))
                weights.append('%s%d_h2h_weight' % (j, i))
                biases.append('%s%d_i2h_bias' % (j, i))
                biases.append('%s%d_h2h_bias' % (j, i))
        return weights + biases

    def _layers(self):
        """``[(wx, wh, bx, bh), ...]`` a layer and direction, the
        forward direction first: the ``RNN`` op's unpacked order."""
        return [tuple(getattr(self, '%s%d_%s' % (j, i, n))
                      for n in ('i2h_weight', 'h2h_weight', 'i2h_bias',
                                'h2h_bias'))
                for i in range(self._num_layers)
                for j in ['l', 'r'][:self._dir]]

    def _shape_hint(self, inputs, *states):
        ni = inputs.shape[2]
        for j in ['l', 'r'][:self._dir]:
            p = self._reg_params['%s0_i2h_weight' % j]
            if p.shape and p.shape[1] == 0:
                p.shape = (self._gates * self._hidden_size, ni)

    def __call__(self, inputs, states=None, **kwargs):
        """``output`` if ``states`` is None, else ``(output,
        new_states)`` (parity: _RNNLayer.forward, rnn_layer.py:244).
        The call goes through ``Block.__call__`` with the states as
        arguments of their own, so a hybridized call is keyed by them."""
        if states is None:
            return super().__call__(inputs, **kwargs)[0]
        if not isinstance(states, (list, tuple)):
            states = [states]
        out = super().__call__(inputs, *states, **kwargs)
        return out[0], list(out[1:])

    def forward(self, inputs, *states):
        """``(output, h_n[, c_n])`` of ``inputs`` in the layer's layout,
        from ``states`` (zeros where none are given)."""
        if self._layout == 'NTC':
            inputs = inputs.transpose(0, 1)
        ni = inputs.shape[2]
        for j in ['l', 'r'][:self._dir]:
            name = '%s0_i2h_weight' % j
            if isinstance(getattr(self, name), _LAZY):
                self._finish_param(name, (self._gates * self._hidden_size,
                                          ni))
        if not states:
            shape = (self._num_layers * self._dir, inputs.shape[1],
                     self._hidden_size)
            states = [torch.zeros(shape, dtype=inputs.dtype,
                                  device=inputs.device)
                      for _ in self.state_info()]
        flat = [w for layer in self._layers() for w in layer]
        args = _amp.transform_inputs(
            "RNN", (inputs, *states) + tuple(flat))
        inputs, states = args[0], args[1:1 + len(states)]
        flat = args[1 + len(states):]
        layers = [tuple(flat[k:k + 4]) for k in range(0, len(flat), 4)]
        out, h, c = rnn_fused(
            inputs, layers, states[0],
            states[1] if self._mode == 'lstm' else None,
            num_layers=self._num_layers, mode=self._mode,
            bidirectional=self._dir == 2, p=self._dropout,
            training=_autograd.is_training())
        if self._layout == 'NTC':
            out = out.transpose(0, 1)
        if self._mode == 'lstm':
            return out, h, c
        return out, h

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        """Cell-style unroll API on the fused layer (convenience)."""
        from .rnn_cell import _format_sequence
        F, inputs, axis, batch_size = _format_sequence(length, inputs,
                                                       layout, True)
        states = begin_state or self.begin_state(
            batch_size, func=F.zeros, ctx=inputs.context)
        outputs, states = self(
            inputs if layout == self._layout
            else F.swapaxes(inputs, dim1=0, dim2=1), states)
        if layout != self._layout:
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if valid_length is not None:
            outputs = F.SequenceMask(outputs, sequence_length=valid_length,
                                     use_sequence_length=True, axis=axis)
        if merge_outputs is False:
            outputs = F.split(outputs, num_outputs=length, axis=axis,
                              squeeze_axis=True)
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh/relu nonlinearity
    (parity: rnn_layer.py:307)."""

    def __init__(self, hidden_size, num_layers=1, activation='relu',
                 layout='TNC', dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'rnn_' + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (parity: rnn_layer.py:404)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'lstm', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'},
                {'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class GRU(_RNNLayer):
    """Multi-layer GRU (cuDNN variant: reset gate applied to h2h output)
    (parity: rnn_layer.py:535)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'gru', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]
