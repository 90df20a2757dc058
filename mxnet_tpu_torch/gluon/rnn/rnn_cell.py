"""Recurrent cells (the port's counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``; parity:
``python/mxnet/gluon/rnn/rnn_cell.py``).

Single-step cells plus combinators (sequential, bidirectional, residual,
zoneout, dropout).  ``unroll`` runs the Python time loop over NDArrays
(``F`` is ``mx.nd``; torch tensors handed to it are wrapped first).  A
hybrid cell's step is its ``hybrid_forward(F, inputs, states,
**params)``, run by ``gluon.block``'s machinery; ``cell(inputs,
states)`` passes the states as arguments of their own, so a hybridized
cell captures one graph per step signature.  Under ``autograd.record()``
a hybridized cell unrolled T steps finds its graph pair busy from the
second step on (the first step's backward is pending), and those steps
run eagerly (``stats()["busy_calls"]``).  A cell that keeps state in
Python between steps (``ZoneoutCell``'s previous output,
``VariationalDropoutCell``'s masks) reads it outside its arguments, so
its own hybridized steps run eagerly (``stats()["host_state_calls"]``);
a hybridized block that unrolls it inside one call captures the whole
unroll.  For long sequences prefer the fused ``rnn.RNN/LSTM/GRU`` layers
(``rnn_layer.py``).
"""
from __future__ import annotations

import torch

from ... import ndarray as nd_mod
from ...ndarray.ndarray import NDArray
from ..block import Block, HybridBlock, _hybrid_call, _nd_in

__all__ = ['RecurrentCell', 'HybridRecurrentCell', 'RNNCell', 'LSTMCell',
           'GRUCell', 'SequentialRNNCell', 'HybridSequentialRNNCell',
           'DropoutCell', 'ModifierCell', 'ZoneoutCell', 'ResidualCell',
           'BidirectionalCell']


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        begin_state = cell.begin_state(func=F.zeros, batch_size=batch_size,
                                       ctx=first.context)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize inputs to a list of (N, C) steps or a merged tensor.

    Returns (F, inputs, axis, batch_size) like the reference
    (rnn_cell.py:53); F is the ``mx.nd`` namespace, and torch tensors
    are wrapped as NDArrays over them."""
    assert inputs is not None, \
        "unroll(inputs=None) is not supported; pass an NDArray or list"
    inputs = _nd_in(inputs, NDArray) if isinstance(
        inputs, (torch.Tensor, list, tuple)) else inputs
    axis = layout.find('T')
    batch_axis = layout.find('N')
    F = nd_mod
    if isinstance(inputs, (list, tuple)):
        length = length or len(inputs)
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = F.stack(*inputs, axis=axis)
    else:
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            in_axis = (in_layout or layout).find('T')
            if length is None:
                length = inputs.shape[in_axis]
            assert length == inputs.shape[in_axis], \
                "length %s does not match time dim %s" % (
                    length, inputs.shape[in_axis])
            inputs = F.split(inputs, num_outputs=length, axis=in_axis,
                             squeeze_axis=True)
            if length == 1:
                inputs = [inputs]
    return F, inputs, axis, batch_size


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis,
                                   merge):
    assert valid_length is not None
    if not isinstance(data, (list, tuple)):
        outputs = F.SequenceMask(data, sequence_length=valid_length,
                                 use_sequence_length=True, axis=time_axis)
    else:
        outputs = F.SequenceMask(F.stack(*data, axis=time_axis),
                                 sequence_length=valid_length,
                                 use_sequence_length=True, axis=time_axis)
        if not merge:
            outputs = F.split(outputs, num_outputs=length, axis=time_axis,
                              squeeze_axis=True)
            if length == 1:
                outputs = [outputs]
    return outputs


def _reverse_sequences(sequences, unroll_step, valid_length=None):
    F = nd_mod
    if valid_length is None:
        reversed_sequences = list(reversed(sequences))
    else:
        reversed_sequences = F.SequenceReverse(
            F.stack(*sequences, axis=0), sequence_length=valid_length,
            use_sequence_length=True)
        if unroll_step > 1:
            reversed_sequences = F.split(reversed_sequences,
                                         num_outputs=unroll_step, axis=0,
                                         squeeze_axis=True)
        else:
            reversed_sequences = [reversed_sequences]
    return reversed_sequences


class RecurrentCell(Block):
    """Abstract single-step recurrent cell (parity: rnn_cell.py:125)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    @property
    def _children(self):
        return self._modules

    def reset(self):
        """Reset the step counter used to name begin-state arrays."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states, one array per entry of ``state_info``."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info = dict(info)
                info.update(kwargs)
            else:
                info = dict(kwargs)
            shape = info.pop('shape')
            info.pop('__layout__', None)
            states.append(func(shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        """Unroll the cell ``length`` steps (parity: rnn_cell.py:205)."""
        self.reset()
        F, inputs, axis, batch_size = _format_sequence(
            length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)

        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [F.SequenceLast(F.stack(*ele_list, axis=0),
                                     sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(
                F, outputs, length, valid_length, axis, True)
        _, outputs, _, _ = _format_sequence(length, outputs, layout,
                                            merge_outputs)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):  # pragma: no cover - abstract
        raise NotImplementedError


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Recurrent cell whose step is expressed via ``hybrid_forward``.

    ``cell(inputs, states)`` calls the block with the states as
    arguments of their own (a hybridized call is keyed by them) and
    returns ``(output, new_states)``."""

    # reads state kept in Python between steps (not in its arguments):
    # its own hybridized calls run eagerly
    _host_state = False

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._host_state_calls = 0

    def __call__(self, inputs, states):
        self._counter += 1
        if not isinstance(states, (list, tuple)):
            states = [states]
        out, new_states = Block.__call__(self, inputs, *states)
        return out, list(new_states)

    def _call(self, *args, **kwargs):
        if self._host_state and self._active:
            self._host_state_calls += 1
            return Block._call(self, *args, **kwargs)
        return super()._call(*args, **kwargs)

    def stats(self):
        """``HybridBlock.stats()`` and the hybridized calls run eagerly
        for state kept in Python (``host_state_calls``)."""
        return dict(super().stats(), host_state_calls=self._host_state_calls)

    def forward(self, inputs, *states):
        return _hybrid_call(self, (inputs, list(states)))

    def hybrid_forward(self, F, x, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell: h' = act(W_x x + b_x + W_h h + b_h)
    (parity: rnn_cell.py:327)."""

    def __init__(self, hidden_size, activation='tanh',
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                'i2h_weight', shape=(hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                'h2h_weight', shape=(hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                'i2h_bias', shape=(hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                'h2h_bias', shape=(hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'rnn'

    def _shape_hint(self, inputs, states):
        _deferred_input(self, self._hidden_size, inputs)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]

    def __repr__(self):
        shape = _shape_of(self.i2h_weight)
        return '%s(%s -> %s, %s)' % (self.__class__.__name__,
                                     shape[1] if shape else 0,
                                     self._hidden_size, self._activation)


def _shape_of(t):
    return None if isinstance(t, torch.nn.parameter.UninitializedTensorMixin) \
        else tuple(t.shape)


def _deferred_input(cell, rows, inputs):
    """Give a deferred ``i2h_weight`` its input width from ``inputs``."""
    p = cell._reg_params['i2h_weight']
    if p.shape and p.shape[1] == 0:
        p.shape = (rows, inputs.shape[-1])
    if isinstance(cell.i2h_weight, torch.nn.parameter.UninitializedTensorMixin):
        cell._finish_param('i2h_weight', p.shape)


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order (i, f, g, o) matching the reference's
    fused kernels (parity: rnn_cell.py:428; gates rnn-inl.h)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None,
                 activation='tanh', recurrent_activation='sigmoid'):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        with self.name_scope():
            self.i2h_weight = self.params.get(
                'i2h_weight', shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                'h2h_weight', shape=(4 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                'i2h_bias', shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                'h2h_bias', shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'},
                {'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'lstm'

    def _shape_hint(self, inputs, states):
        _deferred_input(self, 4 * self._hidden_size, inputs)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4)
        in_gate = self._get_activation(F, slice_gates[0],
                                       self._recurrent_activation)
        forget_gate = self._get_activation(F, slice_gates[1],
                                           self._recurrent_activation)
        in_transform = self._get_activation(F, slice_gates[2],
                                            self._activation)
        out_gate = self._get_activation(F, slice_gates[3],
                                        self._recurrent_activation)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]

    def __repr__(self):
        shape = _shape_of(self.i2h_weight)
        return '%s(%s -> %s)' % (self.__class__.__name__,
                                 shape[1] if shape else 0, self._hidden_size)


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order (r, z, n); reset gate applied to the h2h
    new-memory term — matching the reference/cuDNN convention
    (parity: rnn_cell.py:554)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                'i2h_weight', shape=(3 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                'h2h_weight', shape=(3 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                'i2h_bias', shape=(3 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                'h2h_bias', shape=(3 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'gru'

    def _shape_hint(self, inputs, states):
        _deferred_input(self, 3 * self._hidden_size, inputs)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type='sigmoid')
        update_gate = F.Activation(i2h_z + h2h_z, act_type='sigmoid')
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type='tanh')
        ones = F.ones_like(update_gate)
        next_h = (ones - update_gate) * next_h_tmp \
            + update_gate * prev_state_h
        return next_h, [next_h]

    def __repr__(self):
        shape = _shape_of(self.i2h_weight)
        return '%s(%s -> %s)' % (self.__class__.__name__,
                                 shape[1] if shape else 0, self._hidden_size)


class SequentialRNNCell(RecurrentCell):
    """Stack cells; each step runs them in order (parity: rnn_cell.py:682)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __repr__(self):
        return '%s(\n%s\n)' % (
            self.__class__.__name__,
            '\n'.join('(%s): %r' % (i, c)
                      for i, c in enumerate(self._children.values())))

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, func=func, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._children.values()), \
            "BidirectionalCell is only supported as the top-most cell"
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        self.reset()
        F, inputs, _, batch_size = _format_sequence(length, inputs, layout,
                                                    None)
        num_cells = len(self._children)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args):  # pragma: no cover
        raise NotImplementedError


class HybridSequentialRNNCell(HybridRecurrentCell):
    """Hybridizable sequential stack (parity: rnn_cell.py:760)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __repr__(self):
        return '%s(\n%s\n)' % (
            self.__class__.__name__,
            '\n'.join('(%s): %r' % (i, c)
                      for i, c in enumerate(self._children.values())))

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, func=func, **kwargs)

    def __call__(self, inputs, states):
        return SequentialRNNCell.__call__(self, inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        return SequentialRNNCell.unroll(
            self, length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class DropoutCell(HybridRecurrentCell):
    """Apply dropout on input (parity: rnn_cell.py:835)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert isinstance(rate, (int, float))
        self._rate = rate
        self._axes = axes

    def __repr__(self):
        return '%s(rate=%s, axes=%s)' % (self.__class__.__name__,
                                         self._rate, self._axes)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return 'dropout'

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        self.reset()
        F, inputs, _, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if isinstance(inputs, NDArray):
            return self.hybrid_forward(F, inputs, begin_state or [])
        return super().unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)


class ModifierCell(HybridRecurrentCell):
    """Base for cells that wrap another cell and modify its computation
    (parity: rnn_cell.py:890).  The wrapped cell's parameters are owned by
    the wrapped cell; the modifier holds no parameters of its own."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):  # pragma: no cover
        raise NotImplementedError

    def __repr__(self):
        return '%s(%r)' % (self.__class__.__name__, self.base_cell)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (Krueger et al.) — randomly preserve previous
    state values (parity: rnn_cell.py:932).  Its previous output lives
    in Python between steps, so its own hybridized steps run eagerly."""

    _host_state = True

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        assert not isinstance(base_cell, SequentialRNNCell) or not any(
            isinstance(c, BidirectionalCell)
            for c in base_cell._children.values()), \
            "SequentialRNNCell containing a BidirectionalCell doesn't " \
            "support zoneout."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def __repr__(self):
        return '%s(p_out=%s, p_state=%s, %r)' % (
            self.__class__.__name__, self.zoneout_outputs,
            self.zoneout_states, self.base_cell)

    def _alias(self):
        return 'zoneout'

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: F.Dropout(F.ones_like(like), p=p))
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0. else next_output)
        states = ([F.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0. else next_states)
        self._prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Add residual connection: output = base(input) + input
    (parity: rnn_cell.py:977)."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge_outputs = (isinstance(outputs, NDArray)
                         if merge_outputs is None else merge_outputs)
        F, inputs, _, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if valid_length is not None:
            axis = layout.find('T')
            inputs = _mask_sequence_variable_length(F, inputs, length,
                                                    valid_length, axis,
                                                    merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [out + inp for out, inp in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Run two cells over the sequence in opposite directions and concat
    their outputs (parity: rnn_cell.py:1018).  Only usable via ``unroll``."""

    def __init__(self, l_cell, r_cell, output_prefix='bi_'):
        super().__init__(prefix='', params=None)
        self.register_child(l_cell, 'l_cell')
        self.register_child(r_cell, 'r_cell')
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def __repr__(self):
        return '%s(forward=%r, backward=%r)' % (
            self.__class__.__name__, self._children['l_cell'],
            self._children['r_cell'])

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, func=func, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        self.reset()
        F, inputs, axis, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        reversed_inputs = list(_reverse_sequences(inputs, length,
                                                  valid_length))
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)

        states = begin_state
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info())],
            layout=layout, merge_outputs=merge_outputs,
            valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs,
            begin_state=states[len(l_cell.state_info()):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        reversed_r_outputs = _reverse_sequences(r_outputs, length,
                                                valid_length)

        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, NDArray)
            _, l_outputs, _, _ = _format_sequence(None, l_outputs, layout,
                                                  merge_outputs)
        _, reversed_r_outputs, _, _ = _format_sequence(
            None, reversed_r_outputs, layout, merge_outputs)

        if merge_outputs:
            reversed_r_outputs = F.stack(*reversed_r_outputs, axis=axis) \
                if isinstance(reversed_r_outputs, list) else \
                reversed_r_outputs
            outputs = F.concat(l_outputs, reversed_r_outputs, dim=2)
        else:
            outputs = [F.concat(l_o, r_o, dim=1)
                       for l_o, r_o in zip(l_outputs, reversed_r_outputs)]
        if valid_length is not None:
            outputs = _mask_sequence_variable_length(
                F, outputs, length, valid_length, axis, merge_outputs)
        states = l_states + r_states
        return outputs, states
