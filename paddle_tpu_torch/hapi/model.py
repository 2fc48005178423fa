"""hapi Model — high-level fit/evaluate/predict (port of
``paddle_tpu/hapi/model.py``).

Reference: python/paddle/hapi/model.py (Model.fit/evaluate/predict driving
dygraph or static exec + callbacks + summary/flops).  Training steps run
through ``jit.TrainStep`` over the network (eager: forward, backward,
update); ``train_batch`` returns ``float(loss)``, one host read a step,
as the JAX one does.  ``fit``/``evaluate``/``predict`` ignore
``num_workers``, as the JAX ones do: build the ``DataLoader`` with its
workers and pass it in.
"""

import numpy as np

from .callbacks import ProgBarLogger


def _tuplize(x):
    if x is None:
        return ()
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None, **kwargs):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = list(_tuplize(metrics))

    # ------------------------------------------------------------ train ----
    def _ensure_step(self):
        if self._train_step is None:
            from ..jit import TrainStep

            def loss_fn(out, *labels):
                return self._loss(out, *labels)

            self._train_step = TrainStep(self.network, loss_fn,
                                         self._optimizer)
        return self._train_step

    def train_batch(self, inputs, labels=None, update=True):
        step = self._ensure_step()
        loss = step(_tuplize(inputs), _tuplize(labels))
        return [float(loss)]

    def eval_batch(self, inputs, labels=None):
        was_training = self.network.training
        self.network.eval()
        try:
            out = self.network(*_tuplize(inputs))
            loss = self._loss(out, *_tuplize(labels)) if self._loss else None
            metrics = []
            for m in self._metrics:
                # Paddle's to_list: one array is one argument (the JAX
                # body unpacks it into rows and raises, ROADMAP C)
                m.update(*_tuplize(m.compute(out, *_tuplize(labels))))
                metrics.append(m.accumulate())
            return ([float(loss)] if loss is not None else []), metrics
        finally:
            if was_training:
                self.network.train()

    def predict_batch(self, inputs):
        was_training = self.network.training
        self.network.eval()
        try:
            out = self.network(*_tuplize(inputs))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            return [np.asarray(o) for o in outs]   # bf16 comes as f32
        finally:
            if was_training:
                self.network.train()

    # -------------------------------------------------------------- loops --
    def _loader(self, data, batch_size, shuffle=False, drop_last=False):
        from ..io import DataLoader

        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._loader(train_data, batch_size, shuffle,
                              drop_last=drop_last)
        cbs = list(_tuplize(callbacks))
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.append(ProgBarLogger(log_freq=log_freq, verbose=verbose))
        for cb in cbs:
            cb.set_model(self)
        for cb in cbs:
            cb.on_train_begin()
        history = {"loss": []}
        it = 0
        for epoch in range(epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            for step, batch in enumerate(loader):
                inputs, labels = batch[:-1], batch[-1]
                (loss,) = self.train_batch(inputs, labels)
                history["loss"].append(loss)
                logs = {"loss": loss}
                for cb in cbs:
                    cb.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                ev = self.evaluate(eval_data, batch_size=batch_size,
                                   verbose=0)
                for cb in cbs:
                    cb.on_eval_end(ev)
                for k, v in ev.items():
                    history.setdefault("val_" + k, []).append(v)
            for cb in cbs:
                cb.on_epoch_end(epoch)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            if any(getattr(c, "stopped", False) for c in cbs):
                break
            if num_iters is not None and it >= num_iters:
                break
        for cb in cbs:
            cb.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._loader(eval_data, batch_size)
        for m in self._metrics:
            m.reset()
        losses = []
        for i, batch in enumerate(loader):
            if num_iters is not None and i >= num_iters:
                break
            inputs, labels = batch[:-1], batch[-1]
            loss, _ = self.eval_batch(inputs, labels)
            losses.extend(loss)
        out = {}
        if losses:
            out["loss"] = float(np.mean(losses))
        for m in self._metrics:
            name = m.name() if callable(getattr(m, "name", None)) else \
                type(m).__name__
            out[name] = m.accumulate()
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size)
        outs = []
        for batch in loader:
            if not isinstance(batch, (tuple, list)):
                batch = (batch,)
            outs.append(self.predict_batch(batch))
        if stack_outputs and outs:
            n = len(outs[0])
            return [np.concatenate([o[i] for o in outs]) for i in range(n)]
        return outs

    # ------------------------------------------------------------- state ---
    def save(self, path, training=True):
        from ..framework_io import save

        save({k: v.numpy() for k, v in self.network.state_dict().items()},
             path + ".pdparams")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework_io import load

        self.network.set_state_dict(load(path + ".pdparams"))

    def parameters(self, *a, **k):
        return self.network.parameters(*a, **k)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size)


def summary(net, input_size=None, dtypes=None):
    """Parameter-count summary (reference hapi/model_summary.py)."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if not p.stop_gradient:
            trainable += n
        rows.append((name, list(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Param #':>12}"]
    lines.append("-" * (width + 32))
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    lines.append("-" * (width + 32))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    lines.append(f"Non-trainable params: {total - trainable:,}")
    text = "\n".join(lines)
    print(text)
    return {"total_params": total, "trainable_params": trainable}
