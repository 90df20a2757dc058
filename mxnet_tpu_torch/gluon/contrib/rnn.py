"""Contrib recurrent cells (the port's counterpart of
``mxnet_tpu/gluon/contrib/rnn.py``; parity:
gluon/contrib/rnn/rnn_cell.py and conv_rnn_cell.py).

``VariationalDropoutCell`` — one dropout mask shared across time steps
(Gal & Ghahramani 2016) for inputs/states/outputs; its masks live in
Python between steps, so its own hybridized steps run eagerly (as
``ZoneoutCell``'s do).  ``LSTMPCell`` — LSTM with a recurrent projection
(Sak et al. 2014).  The nine ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``s run
their transforms through the port's ``Convolution`` (cuDNN on the
card).
"""
from __future__ import annotations

from ..rnn.rnn_cell import ModifierCell, HybridRecurrentCell, \
    BidirectionalCell, SequentialRNNCell, _deferred_input
from ..block import HybridBlock  # noqa: F401  (re-export convenience)


class VariationalDropoutCell(ModifierCell):
    """Variational dropout over a base cell (parity:
    contrib/rnn/rnn_cell.py:27).  Masks are drawn once per sequence
    (first step after ``reset``) and reused every step; input, state and
    output masks are independent."""

    _host_state = True

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        assert not drop_states or not isinstance(base_cell,
                                                 BidirectionalCell), \
            "BidirectionalCell doesn't support variational state " \
            "dropout; wrap the cells underneath instead."
        assert not drop_states or not isinstance(base_cell,
                                                 SequentialRNNCell), \
            "Apply VariationalDropoutCell to the cells underneath the " \
            "SequentialRNNCell instead."
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_input_masks(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(
                F.ones_like(states[0]), p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(
                F.ones_like(inputs), p=self.drop_inputs)

    def _initialize_output_mask(self, F, output):
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(
                F.ones_like(output), p=self.drop_outputs)

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        self._initialize_input_masks(F, inputs, states)
        if self.drop_states:
            states = list(states)
            # state dropout applies to the first state channel only
            # (reference semantics)
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = cell(inputs, states)
        self._initialize_output_mask(F, next_output)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def __repr__(self):
        return "VariationalDropoutCell(p_out=%s, p_state=%s)" % (
            self.drop_outputs, self.drop_states)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with recurrent projection (parity:
    contrib/rnn/rnn_cell.py:197; arXiv:1402.1128).

    States are [projected (B, P), cell (B, H)]; the hidden state is
    projected to P units before recurrence and output.
    """

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._projection_size = projection_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def _alias(self):
        return "lstmp"

    def state_info(self, batch_size=0):
        return [
            {"shape": (batch_size, self._projection_size),
             "__layout__": "NC"},
            {"shape": (batch_size, self._hidden_size),
             "__layout__": "NC"},
        ]

    def _shape_hint(self, x, *args):
        _deferred_input(self, 4 * self._hidden_size, x)
        self._input_size = x.shape[-1]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        prefix = "t%d_" % getattr(self, "_counter", 0)
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = i2h + h2h
        sliced = F.SliceChannel(gates, num_outputs=4,
                                name=prefix + "slice")
        sliced = list(sliced) if not isinstance(sliced, (list, tuple)) \
            else sliced
        in_gate = F.Activation(sliced[0], act_type="sigmoid")
        forget_gate = F.Activation(sliced[1], act_type="sigmoid")
        in_transform = F.Activation(sliced[2], act_type="tanh")
        out_gate = F.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size,
                                  name=prefix + "out")
        return next_r, [next_r, next_c]


# ---------------------------------------------------------------------------
# Convolutional recurrent cells (parity: gluon/contrib/rnn/conv_rnn_cell.py)
# ---------------------------------------------------------------------------


class _BaseConvCell(HybridRecurrentCell):
    """Recurrent cell whose i2h/h2h transforms are convolutions over
    NC*-layout feature maps (parity: conv_rnn_cell.py:37
    _BaseConvRNNCell).  ``input_shape`` is the per-sample shape
    ``(channels, *spatial)``; the h2h kernel must be odd so its SAME
    padding keeps the state shape."""

    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate, dims,
                 activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        as_t = lambda v: (v,) * dims if isinstance(v, int) else tuple(v)
        self._dims = dims
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = as_t(i2h_kernel)
        self._h2h_kernel = as_t(h2h_kernel)
        assert all(k % 2 == 1 for k in self._h2h_kernel), \
            "h2h_kernel must be odd (SAME-padded state conv), got %s" \
            % (h2h_kernel,)
        self._i2h_pad = as_t(i2h_pad)
        self._i2h_dilate = as_t(i2h_dilate)
        self._h2h_dilate = as_t(h2h_dilate)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        in_ch = input_shape[0]
        ng = self._num_gates
        # state spatial dims = i2h conv output dims
        self._state_shape = (hidden_channels,) + tuple(
            (x + 2 * p - d * (k - 1) - 1) + 1
            for x, p, d, k in zip(input_shape[1:], self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(ng * hidden_channels, in_ch) + self._i2h_kernel,
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(ng * hidden_channels,
                       hidden_channels) + self._h2h_kernel,
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_channels,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_channels,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        shape = (batch_size,) + self._state_shape
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._dims:]}
                ] * (2 if self._num_gates == 4 else 1)

    def _convs(self, F, inputs, states, i2h_weight, h2h_weight,
               i2h_bias, h2h_bias):
        ng = self._num_gates
        layout = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[self._dims]
        i2h = F.Convolution(
            inputs, i2h_weight, i2h_bias,
            kernel=self._i2h_kernel, pad=self._i2h_pad,
            dilate=self._i2h_dilate, layout=layout,
            num_filter=ng * self._hidden_channels)
        h2h = F.Convolution(
            states[0], h2h_weight, h2h_bias,
            kernel=self._h2h_kernel, pad=self._h2h_pad,
            dilate=self._h2h_dilate, layout=layout,
            num_filter=ng * self._hidden_channels)
        return i2h, h2h

    def _act(self, F, x):
        # same contract as the dense cells: any act_type string the
        # Activation op supports, or a callable block
        return self._get_activation(F, x, self._activation)


class _ConvRNNCellImpl(_BaseConvCell):
    _num_gates = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight,
                               h2h_weight, i2h_bias, h2h_bias)
        out = self._act(F, i2h + h2h)
        return out, [out]


class _ConvLSTMCellImpl(_BaseConvCell):
    _num_gates = 4

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight,
                               h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=1)
        i = F.Activation(slices[0], act_type="sigmoid")
        f = F.Activation(slices[1], act_type="sigmoid")
        c_in = self._act(F, slices[2])
        o = F.Activation(slices[3], act_type="sigmoid")
        next_c = f * states[1] + i * c_in
        next_h = o * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCellImpl(_BaseConvCell):
    _num_gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight,
                               h2h_weight, i2h_bias, h2h_bias)
        i2h_s = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = F.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update = F.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        new_mem = self._act(F, i2h_s[2] + reset * h2h_s[2])
        out = (1.0 - update) * new_mem + update * states[0]
        return out, [out]


def _make_conv_cell(impl, dims, name, doc_line):
    class Cell(impl):
        __doc__ = ("%s over %dD feature maps (parity: "
                   "conv_rnn_cell.py %s)." % (doc_line, dims, name))

        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     activation="tanh", **kwargs):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                             dims, activation=activation, **kwargs)

    Cell.__name__ = Cell.__qualname__ = name
    return Cell


Conv1DRNNCell = _make_conv_cell(_ConvRNNCellImpl, 1, "Conv1DRNNCell",
                                "Convolutional vanilla RNN cell")
Conv2DRNNCell = _make_conv_cell(_ConvRNNCellImpl, 2, "Conv2DRNNCell",
                                "Convolutional vanilla RNN cell")
Conv3DRNNCell = _make_conv_cell(_ConvRNNCellImpl, 3, "Conv3DRNNCell",
                                "Convolutional vanilla RNN cell")
Conv1DLSTMCell = _make_conv_cell(_ConvLSTMCellImpl, 1, "Conv1DLSTMCell",
                                 "ConvLSTM cell (Shi et al. 2015)")
Conv2DLSTMCell = _make_conv_cell(_ConvLSTMCellImpl, 2, "Conv2DLSTMCell",
                                 "ConvLSTM cell (Shi et al. 2015)")
Conv3DLSTMCell = _make_conv_cell(_ConvLSTMCellImpl, 3, "Conv3DLSTMCell",
                                 "ConvLSTM cell (Shi et al. 2015)")
Conv1DGRUCell = _make_conv_cell(_ConvGRUCellImpl, 1, "Conv1DGRUCell",
                                "Convolutional GRU cell")
Conv2DGRUCell = _make_conv_cell(_ConvGRUCellImpl, 2, "Conv2DGRUCell",
                                "Convolutional GRU cell")
Conv3DGRUCell = _make_conv_cell(_ConvGRUCellImpl, 3, "Conv3DGRUCell",
                                "Convolutional GRU cell")
