"""Gluon's recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference
python/mxnet/gluon/rnn/rnn_cell.py): ``RecurrentCell`` (one step a
call, ``unroll`` over a sequence, ``valid_length`` through
``SequenceLast``/``SequenceMask``/``SequenceReverse``),
``HybridRecurrentCell`` and the RNN, LSTM (gate order i, f, g, o) and
GRU (r, z, n) cells, and the Sequential, Dropout, Modifier, Zoneout,
Residual and Bidirectional cells, with the JAX package's parameter
names.  A cell's step runs its ``hybrid_forward`` on NDArrays whether or
not the cell is hybridized, as in the JAX package: the step is a
handful of ops, and ``unroll`` calls it once a time step.
"""
from __future__ import annotations

from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge, F=None):
    """Normalize inputs to a list of (batch, ...) steps or a merged tensor.
    Returns (inputs, axis, F, batch_size).  Default begin states are
    made on the inputs' context (``_context_of``)."""
    from ... import ndarray as F_nd
    from ...ndarray import NDArray
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = F_nd.stack(*inputs, axis=axis)
        in_list = inputs
    else:
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            seq = inputs.shape[axis]
            in_list = F_nd.split(inputs, num_outputs=seq, axis=axis,
                                 squeeze_axis=True)
            if seq == 1:
                in_list = [in_list]
            inputs = list(in_list)
    return inputs, axis, F_nd, batch_size


def _context_of(inputs):
    """The context of a sequence's steps (the default begin states are
    made there, as the reference's ``_get_begin_state`` makes them)."""
    first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
    return first.context


class RecurrentCell(Block):
    """Abstract cell (reference rnn_cell.py RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        from ... import ndarray as nd
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            if func is None:
                states.append(nd.zeros(shape, **kwargs))
            else:
                states.append(func(shape=shape, **kwargs))
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return self.forward(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over ``length`` steps (reference rnn_cell.py:305)."""
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=_context_of(inputs))
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            from ... import ndarray as nd
            # per-sequence last *valid* states, not the states after padding
            # (reference unroll applies F.SequenceLast on stacked states)
            states = [nd.SequenceLast(nd.stack(*ss, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True)
                      for ss in zip(*all_states)]
            stacked = nd.stack(*outputs, axis=0)  # (T, N, C)
            masked = nd.SequenceMask(stacked, sequence_length=valid_length,
                                     use_sequence_length=True)
            outputs = nd.split(masked, num_outputs=length, axis=0,
                               squeeze_axis=True)
            if length == 1:
                outputs = [outputs]
            outputs = list(outputs)
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell whose step is its ``hybrid_forward``, run on NDArrays."""

    def forward(self, inputs, states):
        from ... import ndarray as F
        params = {}
        for name, p in self._reg_params.items():
            try:
                params[name] = p.data()
            except Exception:
                self._infer_cell_shapes(inputs)
                for pp in self._reg_params.values():
                    pp._finish_deferred_init()
                params = {n: pp.data()
                          for n, pp in self._reg_params.items()}
                break
        return self.hybrid_forward(F, inputs, states, **params)

    def _infer_cell_shapes(self, inputs):
        pass


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell: h' = act(W x + b + R h + r)
    (reference rnn_cell.py RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _infer_cell_shapes(self, inputs):
        self.i2h_weight.shape = (self._hidden_size, inputs.shape[1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, cuDNN gate order (i, f, g, o)
    (reference rnn_cell.py LSTMCell)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def _infer_cell_shapes(self, inputs):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.Activation(slices[0], act_type="sigmoid")
        forget_gate = F.Activation(slices[1], act_type="sigmoid")
        in_transform = F.Activation(slices[2], act_type="tanh")
        out_gate = F.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, cuDNN gate order (r, z, n)
    (reference rnn_cell.py GRUCell)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _infer_cell_shapes(self, inputs):
        self.i2h_weight.shape = (3 * self._hidden_size, inputs.shape[1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n,
                                  act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in order (reference rnn_cell.py:660)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            cell_states = states[pos:pos + n]
            pos += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states


class DropoutCell(RecurrentCell):
    """Dropout on cell output (reference rnn_cell.py DropoutCell)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def forward(self, inputs, states):
        from ... import ndarray as F
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate)
        return inputs, states


class ModifierCell(RecurrentCell):
    """Base for cells that wrap another cell
    (reference rnn_cell.py ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        from ... import ndarray as F
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0.0 else next_output
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds input to output (reference rnn_cell.py ResidualCell)."""

    def _alias(self):
        return "residual"

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(RecurrentCell):
    """Runs l_cell forward and r_cell backward over a sequence; only usable
    via unroll (reference rnn_cell.py BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F
        self.reset()
        inputs, axis, _, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=_context_of(inputs))
        l_cell, r_cell = self._children.values()
        l_n = len(l_cell.state_info())
        def _rev(seq):
            # reverse each sequence over its valid steps only (reference
            # uses F.SequenceReverse(sequence_length=valid_length)) so the
            # backward cell starts at the last valid token, not at padding
            if valid_length is None:
                return list(reversed(seq))
            rev = F.SequenceReverse(F.stack(*seq, axis=0),
                                    sequence_length=valid_length,
                                    use_sequence_length=True)
            if length == 1:
                return [F.reshape(rev, shape=rev.shape[1:])]
            return list(F.split(rev, num_outputs=length, axis=0,
                                squeeze_axis=True))

        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:l_n], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=_rev(inputs),
            begin_state=states[l_n:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        outputs = [F.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, _rev(r_outputs))]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
