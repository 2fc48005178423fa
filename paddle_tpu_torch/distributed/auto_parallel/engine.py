"""Engine — auto-parallel train/eval/predict driver.

Reference: auto_parallel/static/engine.py:55 (Engine.fit :854).  Port of
``paddle_tpu/distributed/auto_parallel/engine.py``.  The JAX Engine
shards the model per its metadata over a device mesh, compiles one SPMD
train step and drives the epoch loop.  The port's Engine takes the mesh
of ranks (the ``process_mesh``'s, or every rank of the world along
``"dp"``), slices the model per its metadata (``spmd.shard_parameters``),
averages the gradients over the mesh's first (data) axis with
``DataParallel`` when it has more than one rank, and drives the port's
``TrainStep`` (``remat`` from ``strategy.recompute``) over a
``DataLoader``, each rank taking its block of every batch along the data
axis.  ``save``/``load`` write and read the JAX ``.pdparams`` file
(``framework_io``).
"""

import numpy as np

from ...core.tensor import Tensor
from .process_mesh import ProcessMesh


class _History:
    def __init__(self):
        self.history = {}

    def log(self, name, value):
        self.history.setdefault(name, []).append(value)


class Engine:
    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 cluster=None, strategy=None, process_mesh=None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics is not None else [])
        self._strategy = strategy
        if process_mesh is not None and not isinstance(process_mesh,
                                                       ProcessMesh):
            process_mesh = ProcessMesh(process_mesh, dim_names=["dp"])
        self._process_mesh = process_mesh
        self._train_step = None
        self._mesh = None

    # ------------------------------------------------------------ helpers --
    def _ensure_mesh(self):
        if self._mesh is None:
            if self._process_mesh is not None:
                self._mesh = self._process_mesh.rank_mesh()
            else:
                from ..fleet.topology import RankMesh
                from ..parallel import get_world_size
                self._mesh = RankMesh(np.arange(get_world_size()), ("dp",))
        return self._mesh

    def _ensure_train_step(self):
        if self._train_step is None:
            from ...jit import TrainStep
            from ..fleet.spmd import shard_parameters
            from ..parallel import DataParallel

            mesh = self._ensure_mesh()
            shard_parameters(self._model, mesh)
            model = self._model
            data_axis = mesh.axis_names[0]
            if mesh.axis_size(data_axis) > 1:
                model = DataParallel(model, group=mesh.group(data_axis))
            remat = bool(self._strategy and self._strategy.recompute.enable)
            self._train_step = TrainStep(model, self._loss,
                                         self._optimizer, remat=remat)
        return self._train_step

    def _loader(self, data, batch_size):
        from ...io import DataLoader

        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=False,
                          drop_last=True)

    def _shard(self, batch):
        from ..fleet.spmd import shard_batch

        return shard_batch(batch, self._ensure_mesh(),
                           axes=(self._ensure_mesh().axis_names[0],))

    # ------------------------------------------------------------- public --
    def fit(self, train_data, epochs=1, batch_size=1, steps_per_epoch=None,
            valid_data=None, log_freq=10, verbose=1):
        step_fn = self._ensure_train_step()
        loader = self._loader(train_data, batch_size)
        hist = _History()
        for epoch in range(epochs):
            for i, batch in enumerate(loader):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                batch = self._shard(batch)
                inputs, labels = batch[:-1], batch[-1]
                loss = step_fn(tuple(inputs), (labels,))
                hist.log("loss", float(loss))
            if valid_data is not None:
                ev = self.evaluate(valid_data, batch_size=batch_size,
                                   verbose=0)
                for k, v in ev.items():
                    hist.log("val_" + k, v)
        return hist

    def evaluate(self, valid_data, batch_size=1, steps=None, verbose=1):
        loader = self._loader(valid_data, batch_size)
        was_training = self._model.training
        self._model.eval()
        losses = []
        for m in self._metrics:
            m.reset()
        try:
            for i, batch in enumerate(loader):
                if steps is not None and i >= steps:
                    break
                batch = self._shard(batch)
                inputs, labels = batch[:-1], batch[-1]
                out = self._model(*inputs)
                if self._loss is not None:
                    losses.append(float(self._loss(out, labels)))
                for m in self._metrics:
                    m.update(*m.compute(out, labels))
        finally:
            if was_training:
                self._model.train()
        result = {}
        if losses:
            result["loss"] = float(np.mean(losses))
        for m in self._metrics:
            result[m.name() if callable(getattr(m, "name", None))
                   else type(m).__name__] = m.accumulate()
        return result

    def predict(self, test_data, batch_size=1, steps=None, verbose=1):
        loader = self._loader(test_data, batch_size)
        was_training = self._model.training
        self._model.eval()
        outs = []
        try:
            for i, batch in enumerate(loader):
                if steps is not None and i >= steps:
                    break
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                batch = self._shard(batch)
                out = self._model(*batch)
                outs.append(out.numpy() if isinstance(out, Tensor)
                            else out.detach().cpu().numpy())
        finally:
            if was_training:
                self._model.train()
        return outs

    def save(self, path, training=True):
        from ...framework_io import save

        sd = {k: v.numpy() for k, v in self._model.state_dict().items()}
        save(sd, path + ".pdparams")

    def load(self, path):
        from ...framework_io import load

        sd = load(path + ".pdparams")
        self._model.set_state_dict(sd)
