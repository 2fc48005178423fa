"""hapi callbacks (reference python/paddle/hapi/callbacks.py)."""


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                              else f"{k}: {v}"
                              for k, v in (logs or {}).items())
            print(f"epoch {getattr(self, '_epoch', 0)} step {step}: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        self.stopped = False
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped = True


class ReduceLROnPlateau(Callback):
    """Shrink the LR when the monitored metric stops improving
    (reference callbacks.ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self.cooldown_counter > 0:
            # in cooldown: no reductions and no patience accounting
            self.cooldown_counter -= 1
            self.wait = 0
            if self._better(cur):
                self.best = cur
            return
        if self._better(cur):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait > self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                old = float(opt.get_lr())
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    try:
                        opt.set_lr(new)
                        if self.verbose:
                            print(f"ReduceLROnPlateau: lr {old:.2e} -> "
                                  f"{new:.2e}")
                    except RuntimeError:
                        # optimizer drives lr from an LRScheduler —
                        # plateau reduction cannot compose; warn once
                        if self.verbose:
                            print("ReduceLROnPlateau: optimizer uses an "
                                  "LRScheduler; skipping reduction")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class VisualDL(Callback):
    """Scalar logger (reference callbacks.VisualDL).

    The VisualDL service isn't available here, so scalars stream to a
    JSONL file per run — same information, greppable/plot-able; a real
    VisualDL writer can consume the file later.
    """

    def __init__(self, log_dir="vdl_log"):
        import os

        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = None
        self._step = 0

    def on_train_begin(self, logs=None):
        import os

        if self._f is not None:  # fit() called again on the same callback
            self._f.close()
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def _write(self, tag_prefix, logs):
        import json
        import time

        if self._f is None or not logs:
            return
        for k, v in logs.items():
            if isinstance(v, (int, float)):
                self._f.write(json.dumps(
                    {"tag": f"{tag_prefix}/{k}", "step": self._step,
                     "value": v, "ts": time.time()}) + "\n")
        self._f.flush()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)

    def on_train_end(self, logs=None):
        if self._f is not None:
            self._f.close()
            self._f = None


class ThroughputMonitor(Callback):
    """samples/sec + step-time tracking (reference
    fleet/utils/timer_helper.py + hapi benchmark callback)."""

    def __init__(self, batch_size=1, log_freq=100, verbose=1):
        self.batch_size = batch_size
        self.log_freq = log_freq
        self.verbose = verbose
        self.reset()

    def reset(self):
        import time

        self._t0 = time.perf_counter()
        self._steps = 0
        self.samples_per_sec = 0.0
        self.avg_step_ms = 0.0

    def on_epoch_begin(self, epoch, logs=None):
        self.reset()

    def on_train_batch_end(self, step, logs=None):
        import time

        self._steps += 1
        dt = time.perf_counter() - self._t0
        if dt > 0:
            self.samples_per_sec = self._steps * self.batch_size / dt
            self.avg_step_ms = dt / self._steps * 1e3
        if self.verbose and self._steps % self.log_freq == 0:
            print(f"throughput: {self.samples_per_sec:.1f} samples/s, "
                  f"{self.avg_step_ms:.2f} ms/step")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate_obj", None) or \
            getattr(opt, "_lr_scheduler", None)
        return lr

    def on_train_batch_end(self, step, logs=None):
        lr = self._sched()
        if self.by_step and lr is not None and hasattr(lr, "step"):
            lr.step()

    def on_epoch_end(self, epoch, logs=None):
        lr = self._sched()
        if self.by_epoch and lr is not None and hasattr(lr, "step"):
            lr.step()
