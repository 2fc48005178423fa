"""paddle.quantization parity: QAT (fake-quant) and PTQ (observers).

Port of ``paddle_tpu/quantization/__init__.py`` (reference
python/paddle/quantization/: QuantConfig, QAT/PTQ drivers, quanters,
observers).  The fake-quant is an elementwise torch composition, the
JAX package's ``round``/``clip`` one: its gradient is what autograd
gives that composition (zero through ``round``), with no
straight-through estimator.  The observers' statistics run on the host
in numpy, as the JAX ones do, and none of them moves under a
``jit.to_static`` trace.  ``QuantizedLinear``'s dequantising product is
a plain GEMM (``torch.matmul``), as the JAX one is an XLA dot.

A quantized Layer's weight: ``QuantedLayer`` binds the quanter's output
as the inner layer's weight value for the call, as the JAX package
swaps ``w._data``; the JAX eager tape then differentiates the call with
respect to the weight Tensor at that value, so the port binds
``w + (quanted - w).detach()`` — the quanted value, with the gradient
landing on ``w`` as the JAX tape lands it.
"""

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.mode import is_traced
from ..nn.layer_base import Layer
from ..ops.registry import op


@op("fake_quant_dequant")
def _fake_quant(x, scale, bits=8):
    qmax = 2.0 ** (bits - 1) - 1
    s = torch.clamp(torch.as_tensor(scale, device=x.device), min=1e-9)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    return q * s / qmax


def _absmax(x, detach=True):
    data = x._data if isinstance(x, Tensor) else x
    data = data.detach() if detach else data
    return torch.max(torch.abs(data)) if data.numel() else \
        torch.zeros((), device=data.device)


class BaseQuanter:
    def __init__(self, quant_bits=8):
        self.bits = quant_bits

    def scales(self):
        raise NotImplementedError


class FakeQuanterWithAbsMaxObserver(BaseQuanter):
    """QAT quanter: dynamic abs-max + moving average (reference
    quanters/abs_max.py)."""

    def __init__(self, moving_rate=0.9, quant_bits=8, dtype="float32"):
        super().__init__(quant_bits)
        self.moving_rate = moving_rate
        self._scale = None

    def __call__(self, x):
        absmax_t = _absmax(x, detach=False)
        if is_traced(absmax_t):
            # under a trace the scale stays a traced value (a function of
            # x, as the JAX trace's is) and the host moving average does
            # not move: quantize with this batch's abs-max
            scale = torch.clamp(absmax_t.float(), min=1e-9)
            return _fake_quant(x, scale, bits=self.bits)
        absmax = float(absmax_t.detach())
        if self._scale is None:
            self._scale = absmax
        else:
            self._scale = (self.moving_rate * self._scale
                           + (1 - self.moving_rate) * absmax)
        return _fake_quant(x, np.float32(max(self._scale, 1e-9)),
                           bits=self.bits)

    def scales(self):
        return self._scale


class AbsmaxObserver(BaseQuanter):
    """PTQ observer: running abs-max, no fake-quant in forward (reference
    observers/abs_max.py)."""

    def __init__(self, quant_bits=8):
        super().__init__(quant_bits)
        self._max = 0.0

    def __call__(self, x):
        absmax_t = _absmax(x)
        if is_traced(absmax_t):
            return x  # calibration is an eager pass; no-op under trace
        self._max = max(self._max, float(absmax_t))
        return x

    def scales(self):
        return self._max


class MovingAverageAbsMaxObserver(BaseQuanter):
    """PTQ observer: EMA of per-batch abs-max (reference
    observers/mse.py-family smoothing; robust to outlier batches)."""

    def __init__(self, moving_rate=0.9, quant_bits=8):
        super().__init__(quant_bits)
        self.moving_rate = moving_rate
        self._scale = None

    def __call__(self, x):
        absmax_t = _absmax(x)
        if is_traced(absmax_t):
            return x
        absmax = float(absmax_t)
        self._scale = absmax if self._scale is None else (
            self.moving_rate * self._scale
            + (1 - self.moving_rate) * absmax)
        return x

    def scales(self):
        return self._scale or 0.0


class HistObserver(BaseQuanter):
    """PTQ observer: histogram + percentile clipping (reference
    observers/hist.py) — ignores the outlier tail that would blow up the
    abs-max scale."""

    def __init__(self, quant_bits=8, bins=2048, percentile=0.9999):
        super().__init__(quant_bits)
        self.bins = bins
        self.percentile = percentile
        self._hist = None
        self._range = 0.0

    def __call__(self, x):
        data = x._data if isinstance(x, Tensor) else x
        if is_traced(data):
            return x
        absx = np.abs(data.detach().float().cpu().numpy()).reshape(-1)
        mx = float(absx.max()) if absx.size else 0.0
        if self._hist is None or mx > self._range:
            # re-bin: fold the old histogram into the wider range
            new_range = max(mx, self._range, 1e-9)
            new_hist = np.zeros(self.bins)
            if self._hist is not None and self._range > 0:
                scale = self._range / new_range
                idx = (np.arange(self.bins) * scale).astype(int)
                np.add.at(new_hist, np.clip(idx, 0, self.bins - 1),
                          self._hist)
            self._hist = new_hist
            self._range = new_range
        h, _ = np.histogram(absx, bins=self.bins, range=(0, self._range))
        self._hist += h
        return x

    def scales(self):
        if self._hist is None:
            return 0.0
        c = np.cumsum(self._hist)
        if c[-1] == 0:
            return 0.0
        k = int(np.searchsorted(c, self.percentile * c[-1]))
        return (k + 1) * self._range / self.bins


class KLObserver(HistObserver):
    """PTQ observer: KL-divergence calibration (reference observers/kl.py,
    the TensorRT-style algorithm): choose the clip threshold whose
    quantized distribution diverges least from the observed one."""

    def __init__(self, quant_bits=8, bins=2048):
        super().__init__(quant_bits, bins=bins)

    def scales(self):
        if self._hist is None:
            return 0.0
        hist = self._hist / max(self._hist.sum(), 1e-12)
        levels = 2 ** (self.bits - 1)  # 128 magnitude levels for int8
        # reference cal_kl_threshold semantics: scan from HALF the
        # histogram upward (avoids degenerate tiny thresholds), fold the
        # tail into P only, and build Q by coarsening the UNFOLDED hist
        best_kl, best_i = None, self.bins
        start = max(levels, self.bins // 2)
        for i in range(start, self.bins + 1, max(1, self.bins // 256)):
            p = hist[:i].copy()
            p[-1] += hist[i:].sum()  # clip tail mass into the last bin
            q_src = hist[:i]  # unfolded (reference cal_kl_threshold)
            chunks = np.array_split(q_src, levels)
            q = np.concatenate([
                np.full(len(ch), ch.sum() / max((ch > 0).sum(), 1))
                * (ch > 0) for ch in chunks])
            qsum = q.sum()
            if qsum <= 0:
                continue
            q = q / qsum  # both distributions normalized for a true KL
            p = p / p.sum()
            mask = (p > 0) & (q > 0)
            if not mask.any():
                continue
            kl = float(np.sum(p[mask] * np.log(p[mask] / q[mask])))
            if best_kl is None or kl < best_kl:
                best_kl, best_i = kl, i
        return best_i * self._range / self.bins


class PerChannelAbsMaxQuanter(BaseQuanter):
    """Weight quanter: per-output-channel abs-max scales (reference
    quanters channel_wise_abs_max) — the standard for int8 weights."""

    def __init__(self, quant_bits=8, channel_axis=-1):
        super().__init__(quant_bits)
        self.channel_axis = channel_axis
        self._scales = None

    def __call__(self, w):
        data = w._data if isinstance(w, Tensor) else w
        axes = tuple(i for i in range(data.dim())
                     if i != (self.channel_axis % data.dim()))
        s = torch.amax(torch.abs(data), dim=axes, keepdim=True) if axes \
            else torch.abs(data)
        if not is_traced(s):
            self._scales = s.detach().float().cpu().numpy().reshape(-1)
        qmax = 2.0 ** (self.bits - 1) - 1
        s = torch.clamp(s, min=1e-9)
        q = torch.clamp(torch.round(data / s * qmax), -qmax, qmax)
        out = q * s / qmax
        return _wrap(out) if isinstance(w, Tensor) else out

    def scales(self):
        return self._scales


class QuantConfig:
    """Maps layer types / instances to (activation, weight) quanters."""

    def __init__(self, activation=None, weight=None):
        self._global = (activation, weight)
        self._by_type = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        for t in (layer_type if isinstance(layer_type, (list, tuple))
                  else [layer_type]):
            self._by_type[t] = (activation, weight)

    def factory_for(self, layer):
        for t, fac in self._by_type.items():
            if isinstance(layer, t):
                return fac
        return self._global


class QuantedLayer(Layer):
    """Wraps a layer with activation/weight fake-quant."""

    def __init__(self, inner, act_quanter, weight_quanter):
        super().__init__()
        self._inner = inner
        self._act_q = act_quanter
        self._w_q = weight_quanter

    def forward(self, x):
        if self._act_q is not None:
            x = self._act_q(x)
        if self._w_q is not None and hasattr(self._inner, "weight"):
            w = self._inner.weight
            orig = w._data
            quanted = self._w_q(w)
            if isinstance(quanted, Tensor):
                # the quanted value, differentiated at w (module
                # docstring)
                w._data = orig + (quanted._data - orig).detach()
            try:
                out = self._inner(x)
            finally:
                w._data = orig
            return out
        return self._inner(x)

    def state_dict(self, *a, **k):
        return self._inner.state_dict(*a, **k)


def _wrap_model(model, config, quanter_is_observer):
    from ..nn import Conv2D, Linear

    for name, sub in list(model.named_sublayers()):
        if isinstance(sub, (Linear, Conv2D)):
            act_f, w_f = config.factory_for(sub)
            act_q = act_f() if callable(act_f) else act_f
            w_q = w_f() if callable(w_f) else w_f
            wrapped = QuantedLayer(sub, act_q, w_q)
            parent = model
            parts = name.split(".")
            for p in parts[:-1]:
                parent = getattr(parent, p)
            setattr(parent, parts[-1], wrapped)
    return model


class QuantizedLinear(Layer):
    """Deployment form of a quantized Linear: int8 weight storage +
    per-channel (or per-tensor) dequant scales (reference's converted
    quantized_linear op).  Weight-only int8: the product runs in the
    activation dtype after an on-the-fly dequant (``torch.matmul``).

    qweight/scales are registered buffers, so the converted model
    save/loads through the normal state_dict path."""

    def __init__(self, linear, scales, bits=8, channel_axis=-1):
        super().__init__()
        w = linear.weight._data.detach()  # [in, out]
        qmax = 2.0 ** (bits - 1) - 1
        arr = np.maximum(np.atleast_1d(np.asarray(scales, np.float32)),
                         1e-9)
        if arr.size == 1:
            shape = (1, 1)
        elif channel_axis % 2 == 0:  # per-input-channel
            shape = (-1, 1)
        else:  # per-output-channel (the standard)
            shape = (1, -1)
        s = torch.as_tensor(arr.reshape(shape), dtype=torch.float32,
                            device=w.device)
        q = torch.clamp(torch.round(w / s * qmax), -qmax, qmax)
        self.register_buffer("qweight", Tensor(q.to(torch.int8)))
        self.register_buffer("scales", Tensor(s / qmax))
        self.bias = getattr(linear, "bias", None)
        self.out_dtype = w.dtype

    def forward(self, x):
        # dequantize straight into the stored activation dtype
        w = (self.qweight._data.to(self.out_dtype)
             * self.scales._data.to(self.out_dtype))
        data = x._data if isinstance(x, Tensor) else x
        out = torch.matmul(data, w)
        if self.bias is not None:
            out = out + self.bias._data
        return _wrap(out)


def _has_scales(scales):
    if scales is None:
        return False
    arr = np.atleast_1d(np.asarray(scales, np.float64))
    return arr.size > 0 and bool(np.any(arr > 0))


def _convert_model(model):
    """Replace QuantedLayer wrappers with deployment layers, baking the
    observed scales (reference QAT/PTQ .convert).

    Linear → QuantizedLinear (int8 weight storage).  Other wrapped layers
    with a weight (Conv2D...) get the quantize-dequantize bake applied in
    place — still a real precision reduction, without an int8 storage
    class per layer type."""
    from ..nn import Linear

    for name, sub in list(model.named_sublayers()):
        if not isinstance(sub, QuantedLayer):
            continue
        inner = sub._inner
        replacement = inner  # default: unwrap (no scales observed)
        if sub._w_q is not None and hasattr(inner, "weight"):
            scales = sub._w_q.scales()
            if _has_scales(scales):
                if isinstance(inner, Linear):
                    replacement = QuantizedLinear(
                        inner, scales, bits=sub._w_q.bits,
                        channel_axis=getattr(sub._w_q, "channel_axis",
                                             -1))
                else:
                    # bake fake-quantized weights in place
                    with torch.no_grad():
                        quanted = sub._w_q(inner.weight)
                    inner.weight.set_value(
                        quanted._data if isinstance(quanted, Tensor)
                        else quanted)
        parent = model
        parts = name.split(".")
        for p in parts[:-1]:
            parent = getattr(parent, p)
        setattr(parent, parts[-1], replacement)
    return model


class QAT:
    """Quantization-aware training driver (reference quantization/qat.py)."""

    def __init__(self, config):
        self._config = config

    def quantize(self, model, inplace=True):
        return _wrap_model(model, self._config, False)

    def convert(self, model, inplace=True):
        """Swap fake-quant wrappers for int8 deployment layers."""
        return _convert_model(model)


class PTQ:
    """Post-training quantization driver (reference quantization/ptq.py)."""

    def __init__(self, config):
        self._config = config

    def quantize(self, model, inplace=True):
        return _wrap_model(model, self._config, True)

    def convert(self, model, inplace=True):
        """Bake observed scales into int8 deployment layers."""
        return _convert_model(model)
