"""TensorParallel wrapper (reference meta_parallel/tensor_parallel.py).

Port of ``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``.
The JAX wrapper places each parameter on the hybrid mesh by its
``mesh_axes``.  The port slices each parameter to this rank's block
(``spmd.shard_parameters``: the model then runs Megatron's collectives
over the mp group), and, as the reference does at init, broadcasts the
replicated parameters from the mp group's first rank and every parameter
from the dp group's first rank, so the replicas start equal.
``state_dict()`` returns what the JAX wrapper's returns: whole
parameters in the JAX layout (``spmd.gather_parameters``), as Tensors,
which a ``paddle.save`` of either package then loads.
"""

import torch

from ....core.tensor import Tensor
from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                          broadcast_mp_parameters)
from ...parallel import _Wrapper


class TensorParallel(_Wrapper):
    def __init__(self, layers, hcg, strategy=None):
        from .. import spmd

        super().__init__(layers)
        self._hcg = hcg
        spmd.shard_parameters(layers, hcg.mesh)
        broadcast_mp_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)

    def state_dict(self, *args, **kwargs):
        from .. import spmd

        whole = {k: Tensor(v) for k, v in
                 spmd.gather_parameters(self._layers).items()}
        if isinstance(self._layers, torch.nn.Module):
            return whole
        sd = self._layers.state_dict(*args, **kwargs)
        return {k: whole.get(k, v) for k, v in sd.items()}

    def set_state_dict(self, state_dict, *args, **kwargs):
        """Load a whole (JAX-layout) state dict: each rank keeps its
        blocks."""
        from . import mp_layers

        ctx = mp_layers.mp_of(self._layers)
        rank, size = (0, 1) if ctx is None else (ctx.rank, ctx.size)
        specs = mp_layers.model_specs(self._layers)
        local = {}
        for k, v in state_dict.items():
            data = v._data if isinstance(v, Tensor) else v
            data = data if isinstance(data, torch.Tensor) else \
                torch.as_tensor(data)
            local[k] = mp_layers.block_of(data, *specs.get(k, (None, None)),
                                          rank, size)
        return self._layers.set_state_dict(local, *args, **kwargs)
