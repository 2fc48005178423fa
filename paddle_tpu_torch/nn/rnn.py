"""RNN layers: SimpleRNN / LSTM / GRU (port of ``paddle_tpu/nn/rnn.py``;
reference python/paddle/nn/layer/rnn.py).

Thin Layer wrappers over the ``rnn`` op (``ops/seq_ops.py``), the JAX
package's replacement for the reference's cuDNN flat-weight RNN kernels
(a ``lax.scan`` there, a Python loop of per-step launches here).  The
gate layout (``[i, f, g, o]`` for LSTM, ``[r, z, n]`` for GRU), the
parameter names (``weight_ih_l{k}[_reverse]`` ...) and the
``Uniform(-1/sqrt(H), 1/sqrt(H))`` initialisation are the JAX layers',
so a JAX state dict loads by name.  ``batch_first`` ([B, T, I], Paddle's
default) is handled here; the op is time-major.  The JAX package has no
``RNN``/``BiRNN`` cell wrappers: ``direction="bidirect"`` is its
bidirectional form, and the port's.
"""

import math

import torch

from ..core.tensor import Tensor, _wrap
from ..ops.seq_ops import rnn as _rnn_op
from .initializer import Uniform
from .layer_base import Layer

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        self.dropout = dropout
        gates = _GATES[mode]
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self._weights = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_dim = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                w_ih = self.create_parameter((gates * hidden_size, in_dim),
                                             attr=weight_ih_attr,
                                             default_initializer=init)
                w_hh = self.create_parameter((gates * hidden_size,
                                              hidden_size),
                                             attr=weight_hh_attr,
                                             default_initializer=init)
                b_ih = self.create_parameter((gates * hidden_size,),
                                             attr=bias_ih_attr,
                                             default_initializer=init)
                b_hh = self.create_parameter((gates * hidden_size,),
                                             attr=bias_hh_attr,
                                             default_initializer=init)
                for name_, p in ((f"weight_ih{sfx}", w_ih),
                                 (f"weight_hh{sfx}", w_hh),
                                 (f"bias_ih{sfx}", b_ih),
                                 (f"bias_hh{sfx}", b_hh)):
                    setattr(self, name_, p)
                self._weights.extend([w_ih, w_hh, b_ih, b_hh])

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if isinstance(inputs, Tensor) else _wrap(inputs)
        if not self.time_major:
            x = x.transpose([1, 0, 2])
        b = x.shape[1]
        ld = self.num_layers * self.num_directions
        if initial_states is None:
            zeros = torch.zeros((ld, b, self.hidden_size),
                                dtype=torch.float32, device=x._data.device)
            h0 = Tensor(zeros)
            states = (h0, Tensor(torch.zeros_like(zeros))) \
                if self.mode == "LSTM" else (h0,)
        else:
            states = initial_states if isinstance(initial_states,
                                                  (tuple, list)) \
                else (initial_states,)
        out, final = _rnn_op(
            x, tuple(states), tuple(self._weights),
            sequence_length=sequence_length,
            dropout_prob=self.dropout if self.training else 0.0,
            is_bidirec=self.num_directions == 2,
            input_size=self.input_size, hidden_size=self.hidden_size,
            num_layers=self.num_layers, mode=self.mode,
            is_test=not self.training)
        if not self.time_major:
            out = out.transpose([1, 0, 2])
        if self.mode == "LSTM":
            return out, (final[0], final[1])
        return out, final[0]


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", activation="tanh", **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, **kw)
