"""Pipeline parallelism: the layer descriptions and the microbatch loop.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``
(reference PipelineLayer, parallel_layers/pp_layers.py, and
PipelineParallel, meta_parallel/pipeline_parallel.py:188), with its
semantics: every stage of a ``PipelineLayer`` is built on the rank (its
``segment`` says which layers each stage holds), and
``PipelineParallel.train_batch`` runs one global batch as
``accumulate_steps`` microbatches, accumulating their gradients before
one optimizer step.  Placing the stages on ranks of the ``pp`` axis and
exchanging activations between them is ``paddle_tpu_torch.parallel``'s
work (``pipeline.spmd_pipeline``, ``trainer.SpmdTrainStep``), as it is
``parallel/pipeline.py``'s in the JAX package.
"""

from ....nn.layer_base import Layer
from ....nn.container import LayerList


class LayerDesc:
    """Declarative layer spec for partitioning (reference pp_layers.py)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None, shared_weight_attr=None,
                 *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """Partition a layer list into pipeline stages (reference
    pp_layers.py:887): every stage is built on the rank, and ``segment``
    holds the stage boundaries over the layer list."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        descs = list(layers)
        built = []
        for item in descs:
            built.append(item.build_layer() if isinstance(item, LayerDesc)
                         else item)
        self.run_function = built
        self.layers = LayerList([l for l in built if isinstance(l, Layer)])
        self._num_stages = num_stages or (topology.get_dim("pipe")
                                          if topology else 1)
        # uniform segmentation: stage boundaries over the layer list
        n = len(built)
        per = [n // self._num_stages + (1 if i < n % self._num_stages else 0)
               for i in range(self._num_stages)]
        self.segment = [0]
        for p in per:
            self.segment.append(self.segment[-1] + p)

    def get_stage_layers(self, stage_id):
        return self.run_function[self.segment[stage_id]:
                                 self.segment[stage_id + 1]]

    def forward(self, x):
        for fn in self.run_function:
            x = fn(x)
        return x

    @property
    def num_stages(self):
        return self._num_stages


class PipelineParallel(Layer):
    """The microbatch driver (reference pipeline_parallel.py:188):
    ``train_batch`` splits the global batch into ``accumulate_steps``
    microbatches, runs each through every stage and its loss backward
    (scaled by 1/m), then steps the optimizer once."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        cfg = (strategy.pipeline_configs if strategy else {})
        self.micro_batch_size = cfg.get("micro_batch_size", 1)
        self.accumulate_steps = cfg.get("accumulate_steps", 1)

    def forward(self, x):
        return self._layers(x)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """Run one global batch as microbatches with grad accumulation."""
        inputs, labels = data
        m = self.accumulate_steps
        batch = inputs.shape[0]
        micro = max(batch // m, 1)
        total_loss = None
        optimizer.clear_grad()
        for i in range(m):
            sl = slice(i * micro, (i + 1) * micro)
            out = self._layers(inputs[sl])
            loss = self._layers._loss_fn(out, labels[sl])
            scaled = loss * (1.0 / m)
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total_loss = loss if total_loss is None else total_loss + loss
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total_loss.scale(1.0 / m)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, sd, *args, **kwargs):
        return self._layers.set_state_dict(sd, *args, **kwargs)
