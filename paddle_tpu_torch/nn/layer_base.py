"""nn.Layer: module base class.

Port of ``paddle_tpu/nn/layer_base.py`` (``paddle.nn.Layer`` parity):
parameter/sublayer registries, hooks, ``state_dict`` under the same
structured names in the same order, train/eval.  A parameter is a
``Parameter``, a Tensor over a leaf ``torch.Tensor`` that requires grad
unless it is not trainable; ``set_state_dict`` takes Tensors, numpy
arrays or the ``("__tensor__", array)`` payloads of a checkpoint.
"""

import collections


from ..core.tensor import Tensor
from ..framework.device import _torch_device
from ..framework.dtype import convert_dtype, get_default_dtype


class Parameter(Tensor):
    """Trainable tensor (``paddle.framework.Parameter`` analog)."""

    def __init__(self, data, dtype=None, name=None, trainable=True):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable, name=name)
        self.persistable = True

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


class ParamAttr:
    """Lite ParamAttr (reference python/paddle/fluid/param_attr.py)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


_layer_counter = collections.defaultdict(int)


class Layer:
    def __init__(self, name_scope=None, dtype=None):
        cls = type(self).__name__.lower()
        _layer_counter[cls] += 1
        self._full_name = name_scope or f"{cls}_{_layer_counter[cls] - 1}"
        self._dtype = convert_dtype(dtype) if dtype else get_default_dtype()
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self.training = True

    # ---- attribute routing ----
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning parameters")
            params[name] = value
            layers.pop(name, None) if layers else None
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning sublayers")
            layers[name] = value
            params.pop(name, None) if params else None
            self.__dict__.pop(name, None)
        else:
            if params and name in params:
                if value is None:
                    params.pop(name)
                    object.__setattr__(self, name, value)
                else:
                    raise TypeError(
                        f"cannot assign non-Parameter to parameter slot {name!r}")
            elif layers and name in layers:
                layers.pop(name)
                object.__setattr__(self, name, value)
            elif buffers is not None and name in buffers:
                buffers[name] = value if isinstance(value, Tensor) or value is None \
                    else Tensor(value)
            else:
                object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        return list(super().__dir__()) + list(self._parameters) + \
            list(self._sub_layers) + list(self._buffers)

    # ---- construction helpers ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from .initializer import Constant, XavierUniform
        dtype = convert_dtype(dtype) if dtype else self._dtype
        init = default_initializer
        if isinstance(attr, ParamAttr) and attr.initializer is not None:
            init = attr.initializer
        if attr is False:
            return None
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        data = init(tuple(int(s) for s in shape), dtype)
        trainable = attr.trainable if isinstance(attr, ParamAttr) else True
        p = Parameter(data, trainable=trainable,
                      name=attr.name if isinstance(attr, ParamAttr) else None)
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, Layer):
            raise TypeError("add_sublayer expects a Layer")
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ---- traversal ----
    def children(self):
        yield from self._sub_layers.values()

    def named_children(self):
        yield from self._sub_layers.items()

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, sub in self._sub_layers.items():
            if sub is None or id(sub) in layers_set:
                continue
            layers_set.add(id(sub))
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield sub_prefix, sub
            yield from sub.named_sublayers(prefix=sub_prefix, layers_set=layers_set)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for name, p in self._parameters.items():
            if p is None or id(p) in seen:
                continue
            seen.add(id(p))
            yield (f"{prefix}.{name}" if prefix else name), p
        if include_sublayers:
            for lname, sub in self._sub_layers.items():
                if sub is None:
                    continue
                sub_prefix = f"{prefix}.{lname}" if prefix else lname
                for n, p in sub.named_parameters(prefix=sub_prefix):
                    if id(p) in seen:
                        continue
                    seen.add(id(p))
                    yield n, p

    def named_buffers(self, prefix="", include_sublayers=True):
        for name, b in self._buffers.items():
            if b is None:
                continue
            yield (f"{prefix}.{name}" if prefix else name), b
        if include_sublayers:
            for lname, sub in self._sub_layers.items():
                if sub is None:
                    continue
                sub_prefix = f"{prefix}.{lname}" if prefix else lname
                yield from sub.named_buffers(prefix=sub_prefix)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    # ---- state ----
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else collections.OrderedDict()
        for n, p in self.named_parameters(prefix=structured_name_prefix.rstrip("."),
                                          include_sublayers=include_sublayers):
            dest[n] = p
        for n, b in self.named_buffers(prefix=structured_name_prefix.rstrip("."),
                                       include_sublayers=include_sublayers):
            short = n.rsplit(".", 1)[-1]
            if short not in self._non_persistable_buffer_names:
                dest[n] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for name, target in own.items():
            if name in state_dict:
                value = state_dict[name]
                if isinstance(value, tuple) and len(value) == 2 and \
                        value[0] == "__tensor__":
                    value = value[1]
                if isinstance(value, Tensor):
                    value = value._data
                shape = tuple(value.shape) if hasattr(value, "shape") \
                    else ()
                if shape != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: checkpoint {shape} "
                        f"vs model {tuple(target.shape)}")
                target.set_value(value)
            else:
                missing.append(name)
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ---- modes ----
    def train(self):
        self.training = True
        for sub in self.children():
            sub.train()
        return self

    def eval(self):
        self.training = False
        for sub in self.children():
            sub.eval()
        return self

    def apply(self, fn):
        for sub in self.children():
            sub.apply(fn)
        fn(self)
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Move (``device``) and cast (floating ``dtype``) every parameter
        and buffer, each staying a leaf with its own stop_gradient."""
        dtype = convert_dtype(dtype)
        device = None if device is None else _torch_device(device)
        for t in self.parameters() + self.buffers():
            d = t._data
            cast = dtype is not None and d.is_floating_point()
            if cast or device is not None:
                new = d.detach().to(device=device,
                                    dtype=dtype if cast else None)
                t._rebind(new.requires_grad_(d.requires_grad))
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # ---- hooks ----
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # ---- call ----
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    def full_name(self):
        return self._full_name

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).split("\n")
            sub_repr = "\n  ".join(sub_repr)
            lines.append(f"({name}): {sub_repr}")
        body = ""
        if extra:
            body += extra
        if lines:
            body += ("\n  " if extra else "\n  ") + "\n  ".join(lines) + "\n"
        return f"{type(self).__name__}({body})"
