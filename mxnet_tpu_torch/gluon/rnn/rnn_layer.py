"""Gluon's fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
python/mxnet/gluon/rnn/rnn_layer.py): the same constructors, the same
parameter names (``l0_i2h_weight``, ``r0_h2h_bias``, ...), packed at
each call into the fused ``RNN`` op's flat vector (every weight, then
every bias, layer-major, then direction, i2h before h2h: cuDNN's
layout), layouts TNC and NTC.  As in the JAX package (and the
reference's 1.x ``_RNNLayer``) the layers are ``Block``s, not
``HybridBlock``s: the fused op is one call already.
"""
from __future__ import annotations

from ..block import Block

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _FusedRecurrent(Block):
    """The grid of per-layer, per-direction i2h/h2h parameters, packed
    at each call into the fused op's flat vector (every weight, then
    every bias, each layer-major then direction-major, i2h before
    h2h)."""

    #: number of recurrent state tensors (LSTM overrides with 2)
    _state_arity = 1

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, prefix=None, params=None):
        self._mode = mode  # read by _alias() inside Block.__init__
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise ValueError(
                f"Invalid layout {layout}; must be one of ['TNC', 'NTC']")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = _GATES[mode]

        inits = {"i2h_weight": i2h_weight_initializer,
                 "h2h_weight": h2h_weight_initializer,
                 "i2h_bias": i2h_bias_initializer,
                 "h2h_bias": h2h_bias_initializer}
        for name, shape in self._param_grid(input_size):
            kind = name.split("_", 1)[1]
            param = self.params.get(name, shape=shape, init=inits[kind],
                                    allow_deferred_init=True)
            setattr(self, name, param)

    def _alias(self):
        return self._mode

    def _directions(self):
        return ("l", "r")[:self._dir]

    def _param_grid(self, input_size):
        """Yield (param_name, shape) for every layer x direction x kind."""
        rows = self._gates * self._hidden_size
        width_in = input_size
        for layer in range(self._num_layers):
            for d in self._directions():
                yield f"{d}{layer}_i2h_weight", (rows, width_in)
                yield f"{d}{layer}_h2h_weight", (rows, self._hidden_size)
                yield f"{d}{layer}_i2h_bias", (rows,)
                yield f"{d}{layer}_h2h_bias", (rows,)
            width_in = self._hidden_size * self._dir

    def __repr__(self):
        w = self.l0_i2h_weight.shape
        mapping = f"{w[1] if w[1] else None} -> {w[0] // self._gates}"
        opts = "" if self._num_layers == 1 else f", num_layers={self._num_layers}"
        if self._dropout:
            opts += f", dropout={self._dropout}"
        if self._dir == 2:
            opts += ", bidirectional"
        return f"{type(self).__name__}({mapping}, {self._layout}{opts})"

    # -- states ---------------------------------------------------------
    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}
                for _ in range(self._state_arity)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero (or ``func``-built) initial states for a batch."""
        from ... import ndarray as nd
        make = func or (lambda shape, **kw: nd.zeros(shape, **kw))
        return [make(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    # -- forward --------------------------------------------------------
    def forward(self, inputs, states=None):
        """Run the fused recurrence.  ``states`` optional — when omitted,
        zeros are used and only the output sequence is returned."""
        from ... import ndarray as nd
        batch = inputs.shape[self._layout.index("N")]
        implicit = states is None
        if implicit:
            states = self.begin_state(batch, ctx=inputs.context,
                                      dtype=inputs.dtype)
        elif isinstance(states, nd.NDArray):
            states = [states]
        for info, state in zip(self.state_info(batch), states):
            if state.shape != info["shape"]:
                raise ValueError(
                    f"Invalid recurrent state shape. Expecting "
                    f"{info['shape']}, got {state.shape}.")
        outputs, out_states = self._run_fused(inputs, states)
        return outputs if implicit else (outputs, out_states)

    def _packed_params(self, F):
        """Late-bind deferred shapes from the first input, then concatenate
        the parameter grid into the fused op's flat layout."""
        def flat(name):
            return getattr(self, name).data().reshape((-1,))
        weights = []
        for i in range(self._num_layers):
            for d in self._directions():
                weights += [flat(f"{d}{i}_i2h_weight"),
                            flat(f"{d}{i}_h2h_weight")]
        biases = []
        for i in range(self._num_layers):
            for d in self._directions():
                biases += [flat(f"{d}{i}_i2h_bias"), flat(f"{d}{i}_h2h_bias")]
        return F.concat(*(weights + biases), dim=0)

    def _run_fused(self, inputs, states):
        from ... import ndarray as F
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        if any(p._data is None for p in self._reg_params.values()):
            # first call: bind layer-0 input width, then materialise
            rows = self._gates * self._hidden_size
            for d in self._directions():
                getattr(self, f"{d}0_i2h_weight").shape = \
                    (rows, inputs.shape[2])
            for p in self._reg_params.values():
                p._finish_deferred_init()
        args = [inputs, self._packed_params(F), *states]
        if self._mode != "lstm":
            args = args[:3]
        result = F.RNN(*args, state_size=self._hidden_size,
                       num_layers=self._num_layers,
                       bidirectional=self._dir == 2, p=self._dropout,
                       state_outputs=True, mode=self._mode)
        outputs = result[0]
        out_states = list(result[1:1 + self._state_arity])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, out_states


class RNN(_FusedRecurrent):
    """Multi-layer Elman RNN with relu or tanh activation, fused."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)


class LSTM(_FusedRecurrent):
    """Multi-layer LSTM, fused; carries (h, c) state pair."""

    _state_arity = 2

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)


class GRU(_FusedRecurrent):
    """Multi-layer GRU, fused."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)
