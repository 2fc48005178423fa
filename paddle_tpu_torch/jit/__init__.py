"""jit — the compiled bridge (port of ``paddle_tpu/jit/__init__.py``).

``functional_call``, ``StaticFunction`` / ``to_static`` and
``TrainStep``.

``to_static``.  The JAX package traces a function with ``jax.jit`` once
per input signature and replays the jaxpr with the live weights.  The
port traces it once per signature (treedef, shapes, dtypes, devices,
static leaves, ``training``) with ``make_fx(..., tracing_mode="fake",
pre_dispatch=True)``: the parameters, buffers and tensor inputs are the
graph's inputs, and the cached ``torch.fx.GraphModule`` of aten ops
runs on every call with the live tensors.  It is the port's
counterpart of the jitted jaxpr (the later exporter reads it); it runs
the same on the CPU and on the card, where the kernels inside it are
the ``torch.library`` ops (their ``register_fake`` gives the trace
their shapes).  A replay is differentiable: the graph's ops run under
autograd with the live parameters.

- **The guard.**  While a trace runs (``framework.mode.tracing``), a
  Tensor's host reads (``bool``, ``int``, ``float``, ``numpy``) raise
  the JAX package's TypeError "Data-dependent control flow cannot be
  traced", and so does a torch data-dependent guard
  (``GuardOnDataDependentSymNode``); dy2static converts the
  ``if``/``while``/``for`` statements it can into ``static.nn.cond`` /
  ``while_loop``.
- **Random draws.**  A traced random op would hold the
  ``torch.Generator`` it drew from as a graph constant, and
  ``paddle.seed`` replaces the port's global generators
  (``framework/random.py``).  So the trace runs with a marker
  generator in place of each device's global one, and each marker the
  graph captured becomes a graph input, given the device's current
  global generator on every call: every call draws fresh values from
  the port's current stream and ``paddle.seed`` repeats them, as the
  JAX ``key`` input does.  (A random op inside a ``cond`` or
  ``while_loop`` branch keeps its marker.)
- **Buffers.**  They come back from the graph (the JAX
  ``return_buffers=True``) and are written into the Layer's
  stop-gradient state, as in JAX (BatchNorm's running statistics).
- **Fallback.**  A trace of the converted function that raises for any
  reason other than the guard or dy2static's own NameError retraces the
  unconverted function.  Nothing ever falls back to running eagerly.
- ``ir_passes=`` applies ``framework/ir.py``'s passes to the cached
  graph.

``TrainStep``.  The JAX package compiles forward, backward, clipping and
the optimizer update into one XLA program.  PyTorch runs eagerly: one
call of :class:`TrainStep` does the same four things in order on the
model's device, with the attention and LayerNorm of the model going
through the hand-written CUDA kernels.  Capturing the step in a CUDA
graph is later work (ROADMAP A7c).

The model is a ``torch.nn.Module`` over raw torch tensors (the port's
GPT) or a Paddle ``Layer`` over Tensors (what ``hapi.Model`` steps):
then the inputs and labels are Tensors and so is the loss.  A Layer's
buffers update in place as its forward runs (BatchNorm's running
statistics).  The JAX ``TrainStep`` restores every buffer after its
traced forward, so its BatchNorm statistics never move; the eager JAX
step updates them, and so does the port (ROADMAP C).

``remat=True`` is the JAX ``jax.checkpoint`` of the whole loss:
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` over
``loss_fn(model(*inputs), *labels)``, so the backward recomputes the
forward instead of keeping its activations.  ``checkpoint`` restores
PyTorch's default CPU and CUDA generators before the recompute but not
the explicit ``torch.Generator`` s the port's dropout draws from (the
model's own, ``models/gpt.py``, and the global ones of
``framework/random.py``): the step snapshots each of them before the
forward and restores it before the recompute, so the recompute draws
the same masks and the gradients equal those of ``remat=False``.

``scaler=`` (an enabled ``amp.GradScaler``) composes dynamic loss
scaling into the step, as the JAX step does: the loss is multiplied by
the scale, the gradients are unscaled, checked, clipped and applied
unless one is not finite (``amp.scaler_guarded_update``), the scale and
its counts move on the device, and the unscaled loss is returned.  A
skipped step keeps the parameters and the optimizer state bitwise; the
step count (``state_dict()["step"]``) still advances, as the JAX
``self._step`` does, while the optimizer's own count advances only with
an update.
"""

import contextlib
import inspect
import types

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..amp import scaler_guarded_update, scaler_init_state
from ..core.tensor import Tensor, _wrap
from ..framework import mode
from ..framework import random as _random
from ..nn.layer_base import Layer

def _is_tensor(x):
    return isinstance(x, (Tensor, torch.Tensor))


def _flatten(tree):
    return pytree.tree_flatten(tree, is_leaf=lambda x: isinstance(x, Tensor))


def _as_torch(v, like=None):
    """A value of ``values`` (a Tensor, torch tensor or host array) as a
    torch tensor on ``like``'s device."""
    if isinstance(v, Tensor):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    dev = like.device if like is not None else None
    return torch.as_tensor(np.asarray(v), device=dev)


def _state(layer):
    """``{name: Tensor}`` of every parameter and buffer of a Layer (the
    non-persistable buffers too: a trace takes them as inputs)."""
    out = dict(layer.named_parameters())
    for name, b in layer.named_buffers():
        out.setdefault(name, b)
    return out


def functional_call(layer, values, *args, return_buffers=False,
                    forward_fn=None, **kwargs):
    """Run ``layer(*args, **kwargs)`` with parameters/buffers from
    ``values`` (name -> Tensor, torch tensor or host array) bound in
    place of the Layer's own, which are restored after.  Returns the
    output with Tensors unwrapped to torch tensors; with
    ``return_buffers=True`` also the possibly updated values of the
    names in ``values``.  ``forward_fn`` overrides the callable.  As in
    the JAX package the call records no gradient."""
    sd = layer.state_dict()
    saved = []
    for name, val in values.items():
        t = sd[name]
        saved.append((t, t._data))
        t._data = _as_torch(val, t._data)
    call = forward_fn if forward_fn is not None else layer
    try:
        targs = [a if isinstance(a, Tensor) else
                 _wrap(_as_torch(a)) if isinstance(a, (np.ndarray,
                                                       torch.Tensor)) else a
                 for a in args]
        with mode.grad_enabled(False):
            out = call(*targs, **kwargs)
        out_data = pytree.tree_map(
            lambda t: t._data if isinstance(t, Tensor) else t, out,
            is_leaf=lambda x: isinstance(x, Tensor))
        if return_buffers:
            return out_data, {name: sd[name]._data for name in values}
        return out_data
    finally:
        for t, data in saved:
            t._data = data


def _hashable(x):
    if isinstance(x, (list, tuple)):
        return tuple(_hashable(i) for i in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in x.items()))
    if isinstance(x, np.ndarray):
        return (x.shape, str(x.dtype), x.tobytes())
    return x


def _is_guard(exc):
    return isinstance(exc, GuardOnDataDependentSymNode) or (
        isinstance(exc, TypeError) and mode.TRACE_GUARD_MESSAGE in str(exc))


class _Program:
    """One traced signature: the GraphModule, the layout of its inputs
    and outputs, and the devices whose global generator it takes as
    trailing inputs."""

    def __init__(self, gm, state_names, buffer_names, out_tree, out_kinds,
                 gen_devices):
        self.gm = gm
        self.state_names = state_names
        self.buffer_names = buffer_names
        self.out_tree = out_tree
        self.out_kinds = out_kinds   # "tensor" / "torch" / a static value
        self.gen_devices = gen_devices


# marker seeds of the trace's stand-in generators (module docstring)
_MARKER_SEED = 0x5EED_0000_0000


def _device_key(dev):
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def _marker_generators(devices):
    """The port's global generators of ``devices`` replaced, for the
    body, by fresh generators with distinct marker seeds; yields
    ``{marker seed: device}``."""
    saved = dict(_random._generators)
    markers = {}
    _random._generators.clear()
    try:
        for i, dev in enumerate(devices):
            g = torch.Generator(device=dev)
            g.manual_seed(_MARKER_SEED + i)
            _random._generators[dev] = g
            markers[_MARKER_SEED + i] = dev
        yield markers
    finally:
        _random._generators.clear()
        _random._generators.update(saved)


def _lift_generators(gm, markers):
    """Each marker generator the graph holds as a constant becomes a
    trailing placeholder; returns the devices of those inputs, in
    order."""
    graph = gm.graph
    places = [n for n in graph.nodes if n.op == "placeholder"]
    last = places[-1] if places else None
    lifted, devices = {}, []
    for n in list(graph.nodes):
        obj = getattr(gm, n.target, None) if n.op == "get_attr" else None
        if not isinstance(obj, torch.Generator) or \
                obj.initial_seed() not in markers:
            continue
        seed = obj.initial_seed()
        if seed not in lifted:
            # a program of no inputs takes its first one here
            at = graph.inserting_after(last) if last is not None \
                else graph.inserting_before(next(iter(graph.nodes)))
            with at:
                last = lifted[seed] = graph.placeholder(f"gen_{len(devices)}")
            devices.append(markers[seed])
        n.replace_all_uses_with(lifted[seed])
        graph.erase_node(n)
        delattr(gm, n.target)
    gm.recompile()
    return devices


class StaticFunction:
    """A function or a Layer's forward traced once per input signature
    and replayed (the JAX ``StaticFunction``; module docstring)."""

    def __init__(self, function, layer=None, ir_passes=None, original=None):
        self._function = function
        self._layer = layer
        self._original = original    # the unconverted callable
        self._cache = {}
        # FX pattern-rewrite passes (framework/ir.py): None/False off,
        # True = all registered, or an explicit sequence of pass names
        self._ir_passes = ir_passes

    # ---- signature ----
    def _key(self, leaves, treedef, t_pos):
        sig = tuple((tuple(leaves[i]._data.shape if isinstance(
            leaves[i], Tensor) else leaves[i].shape),
            (leaves[i]._data if isinstance(leaves[i], Tensor)
             else leaves[i]).dtype,
            str((leaves[i]._data if isinstance(leaves[i], Tensor)
                 else leaves[i]).device),
            isinstance(leaves[i], Tensor)) for i in t_pos)
        static = tuple(None if i in t_pos else _hashable(leaves[i])
                       for i in range(len(leaves)))
        training = self._layer.training if self._layer is not None else None
        return (treedef, tuple(t_pos), sig, static, training)

    def __call__(self, *args, **kwargs):
        if mode.in_trace():
            # inside another trace: inline, as a jit inside a jit does
            return self._function(*args, **kwargs)
        leaves, treedef = _flatten((args, kwargs))
        t_pos = [i for i, x in enumerate(leaves) if _is_tensor(x)]
        key = self._key(leaves, treedef, t_pos)
        prog = self._cache.get(key)
        if prog is None:
            prog = self._cache[key] = self._trace(leaves, treedef, t_pos)
        datas = [leaves[i]._data if isinstance(leaves[i], Tensor)
                 else leaves[i] for i in t_pos]
        return self._run(prog, datas)

    # ---- trace ----
    def _trace(self, leaves, treedef, t_pos):
        try:
            return self._trace_with(self._function, leaves, treedef, t_pos)
        except Exception as exc:
            if _is_guard(exc):
                raise TypeError(mode.TRACE_GUARD_MESSAGE) from None
            if self._original is None or isinstance(exc, NameError):
                raise
            try:
                return self._trace_with(self._original, leaves, treedef,
                                        t_pos)
            except Exception as exc2:
                if _is_guard(exc2):
                    raise TypeError(mode.TRACE_GUARD_MESSAGE) from None
                raise exc

    def _trace_with(self, function, leaves, treedef, t_pos):
        layer = self._layer
        state = _state(layer) if layer is not None else {}
        state_names = list(state)
        buffer_names = [n for n in state_names if state[n].stop_gradient]
        ns = len(state_names)
        found = {}

        def traced(*flat):
            saved = [(state[n], state[n]._data) for n in state_names]
            for n, d in zip(state_names, flat[:ns]):
                state[n]._data = d
            try:
                new_leaves = list(leaves)
                for i, d in zip(t_pos, flat[ns:]):
                    new_leaves[i] = _wrap(d) if isinstance(
                        leaves[i], Tensor) else d
                a, k = pytree.tree_unflatten(new_leaves, treedef)
                with mode.tracing():
                    out = function(*a, **k)
                outs, out_tree = _flatten(out)
                found["tree"] = out_tree
                found["kinds"] = [
                    "tensor" if isinstance(o, Tensor) else
                    "torch" if isinstance(o, torch.Tensor) else o
                    for o in outs]
                ret = [o._data if isinstance(o, Tensor) else o
                       for o in outs if _is_tensor(o)]
                ret += [state[n]._data for n in buffer_names]
                return tuple(ret)
            finally:
                for t, d in saved:
                    t._data = d

        example = [state[n]._data.detach() for n in state_names]
        example += [(leaves[i]._data if isinstance(leaves[i], Tensor)
                     else leaves[i]).detach() for i in t_pos]
        devices = {_device_key("cpu")}
        devices.update(_device_key(t.device) for t in example)
        with _marker_generators(sorted(devices, key=str)) as markers:
            # a tensor the function closes over (not an input) is a
            # constant of the graph, inside a cond or while_loop too
            gm = make_fx(traced, tracing_mode="fake", pre_dispatch=True,
                         _allow_non_fake_inputs=True)(*example)
        gm.graph.eliminate_dead_code()
        gen_devices = _lift_generators(gm, markers)
        if self._ir_passes:
            from ..framework import ir
            passes = None if self._ir_passes is True \
                else list(self._ir_passes)
            gm = ir.rewrite(gm, passes)
        return _Program(gm, state_names, buffer_names, found["tree"],
                        found["kinds"], gen_devices)

    # ---- run ----
    def _run(self, prog, datas):
        layer = self._layer
        state = _state(layer) if layer is not None else {}
        flat = list(prog.gm(*[state[n]._data for n in prog.state_names],
                            *datas, *[_random.generator(dev)
                                      for dev in prog.gen_devices]))
        nb = len(prog.buffer_names)
        outs, bufs = flat[:len(flat) - nb], flat[len(flat) - nb:]
        for name, val in zip(prog.buffer_names, bufs):
            t = state[name]
            if t._data is not val:
                t._data = val.detach()
        it = iter(outs)
        leaves = [_wrap(next(it)) if k == "tensor" else
                  next(it) if k == "torch" else k for k in prog.out_kinds]
        return pytree.tree_unflatten(leaves, prog.out_tree)

    def program(self, *args, **kwargs):
        """The cached ``GraphModule`` of the signature of these
        arguments (traced now if it is not yet)."""
        leaves, treedef = _flatten((args, kwargs))
        t_pos = [i for i, x in enumerate(leaves) if _is_tensor(x)]
        key = self._key(leaves, treedef, t_pos)
        if key not in self._cache:
            self._cache[key] = self._trace(leaves, treedef, t_pos)
        return self._cache[key].gm

    @property
    def code(self):
        return inspect.getsource(self._function)


_GRAPH_FUSE_FLAGS = ("fused_attention", "fuse_attention",
                     "fuse_elewise_add_act_ops", "fuse_gemm_epilogue",
                     "fuse_bn_act_ops", "fuse_bn_add_act_ops",
                     "fuse_relu_depthwise_conv")


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Trace a function or a Layer's forward into a cached FX program
    (paddle.jit.to_static parity; module docstring).

    Data-dependent python ``if``/``while``/``for`` on tensor values are
    converted by the dy2static AST pass into ``static.nn.cond`` /
    ``while_loop``; statements the pass can't convert keep the trace
    guard, and a conversion failure falls back to tracing the plain
    function.

    ``ir_passes=True`` (or a sequence of pass names) runs
    ``framework/ir.py``'s pattern-rewrite passes over the traced
    program — the reference's ``build_strategy`` fuse-pass role; a
    BuildStrategy object with any truthy graph ``fuse_*`` attribute
    enables them too.
    """
    from .dy2static import ast_transform

    ir_passes = kwargs.get("ir_passes")
    if ir_passes not in (None, True, False):
        # validate early: a bare string would iterate per-character and a
        # misspelled name would only KeyError deep inside the first trace
        from ..framework import ir as _ir
        if isinstance(ir_passes, str):
            raise TypeError(
                "ir_passes must be True/False or a SEQUENCE of pass "
                f"names, got the string {ir_passes!r} — did you mean "
                f"ir_passes=[{ir_passes!r}]?")
        unknown = [n for n in ir_passes if n not in _ir.PASSES]
        if unknown:
            raise ValueError(
                f"unknown ir pass(es) {unknown}; registered: "
                f"{list(_ir.PASSES)}")
    # explicit ir_passes=False is an OPT-OUT that build_strategy's fuse
    # flags must not override; only graph-fusion flags opt in
    if "ir_passes" not in kwargs and build_strategy is not None:
        ir_passes = any(bool(getattr(build_strategy, a, False))
                        for a in _GRAPH_FUSE_FLAGS)

    def decorate(fn):
        probe = fn.forward if isinstance(fn, Layer) else fn
        probe = getattr(probe, "__func__", probe)
        if inspect.isgeneratorfunction(probe) or \
                inspect.isasyncgenfunction(probe):
            # a traced graph has one static output structure; a
            # generator's yields have none
            raise NotImplementedError(
                "to_static cannot compile a generator function: a "
                "traced program returns a fixed output structure, "
                "but `yield` produces values lazily. Restructure to "
                "accumulate results and return them (e.g. append to a "
                "list and return paddle.stack(outs)), or keep the "
                "generator outside the compiled region.")
        if isinstance(fn, Layer):
            raw = getattr(fn.forward, "__func__", fn.forward)
            conv = ast_transform(raw)
            fwd = types.MethodType(conv, fn) if conv is not None \
                else fn.forward
            fn.forward = StaticFunction(
                fwd, layer=fn, ir_passes=ir_passes,
                original=fn.forward if conv is not None else None)
            return fn
        # a bound method keeps its binding through conversion; a
        # Layer's method takes the Layer's state as graph inputs (never
        # as constants frozen at trace time)
        self_obj = getattr(fn, "__self__", None)
        conv = ast_transform(getattr(fn, "__func__", fn))
        if conv is not None and self_obj is not None:
            conv = types.MethodType(conv, self_obj)
        return StaticFunction(conv if conv is not None else fn,
                              layer=self_obj if isinstance(
                                  self_obj, Layer) else None,
                              ir_passes=ir_passes,
                              original=fn if conv is not None else None)

    if function is not None:
        return decorate(function)
    return decorate


class TrainStep:
    """One whole training step per call.

    Usage::

        step = TrainStep(model, loss_fn, opt)
        loss = step(batch_x, batch_y)   # tensors in, detached loss out

    ``model`` is a ``torch.nn.Module`` fed raw torch tensors or a Paddle
    ``Layer`` fed Tensors (module docstring).

    A call clears the gradients, runs ``loss_fn(model(*inputs),
    *labels)`` (under ``checkpoint`` with ``remat=True``), backward
    (of the scaled loss with ``scaler``), then ``optimizer.step()``
    (which applies the optimizer's ``grad_clip``) or, with ``scaler``,
    the guarded update, and returns the loss.  The parameters and the
    optimizer state are updated in place.  The reference's ``donate``
    has no counterpart: the in-place update already reuses the
    buffers."""

    def __init__(self, model, loss_fn, optimizer, remat=False, scaler=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.remat = remat
        self._step = 0
        self.found_inf = None   # the last scaled step's flag (0-d bool)
        self.scaler = scaler if (scaler is not None and scaler.is_enable()) \
            else None
        if self.scaler is not None:
            self.scaler._compiled_state = scaler_init_state(
                self.scaler, self._device())

    def _device(self):
        p = self.optimizer._parameters[0]
        return (p._data if isinstance(p, Tensor) else p).device

    def _generators(self):
        """Every explicit generator the forward may draw from: those the
        model's modules hold, and the port's global generators (the one
        of the parameters' device created now if it is not yet)."""
        _random.generator(self._device())
        mods = (self.model.modules() if isinstance(self.model,
                                                   torch.nn.Module)
                else self.model.sublayers(include_self=True))
        found = {id(g): g for m in mods for g in vars(m).values()
                 if isinstance(g, torch.Generator)}
        found.update((id(g), g) for g in _random._generators.values())
        return list(found.values())

    def _loss(self, inputs, labels):
        if not self.remat:
            return self.loss_fn(self.model(*inputs), *labels)
        states = [(g, g.get_state()) for g in self._generators()]

        def loss_f(*inputs):
            # the forward draws from these states, and so does the
            # recompute
            for g, state in states:
                g.set_state(state)
            return self.loss_fn(self.model(*inputs), *labels)

        return checkpoint(loss_f, *inputs, use_reentrant=False)

    def __call__(self, inputs, labels=()):
        """inputs: tensor or tuple for the model; labels: tensor or tuple
        for ``loss_fn(output, *labels)``.  Returns the loss, detached."""
        if isinstance(inputs, (torch.Tensor, Tensor)):
            inputs = (inputs,)
        if isinstance(labels, (torch.Tensor, Tensor)):
            labels = (labels,)
        self._step += 1
        self.optimizer.clear_grad()
        loss = self._loss(inputs, labels)
        if self.scaler is None:
            loss.backward()
            self.optimizer.step()
            return loss.detach()
        state = self.scaler._compiled_state
        data = loss._data if isinstance(loss, Tensor) else loss
        (data * state["scale"].to(data.dtype)).backward()
        self.found_inf, self.scaler._compiled_state = scaler_guarded_update(
            self.scaler, state, self.optimizer)
        return loss.detach()

    def state_dict(self):
        return {"params": {k: v.detach() for k, v in
                           self.model.state_dict().items()},
                "opt_state": self.optimizer.state_dict(),
                "step": self._step}


from .save_load import TranslatedLayer, load, save  # noqa: E402,F401
