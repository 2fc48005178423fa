"""paddle.static surface (port of ``paddle_tpu/static/__init__.py``).

The reference's ProgramDesc static graph is replaced by ``jit.to_static``
and its traced FX program.  What is kept: ``InputSpec``,
``save_inference_model`` / ``load_inference_model`` in the ``jit.save``
format, an ``Executor`` that runs callables, and the control flow
``cond`` / ``while_loop``, which lower to ``torch.cond`` and
``torch._higher_order_ops.while_loop`` under a trace — the counterparts
of ``lax.cond`` / ``lax.while_loop``, with their rules: the branches'
outputs match in structure, shape and dtype, the loop's carried shapes
are invariant, and there is no reverse-mode gradient through a traced
loop.  Outside a trace the taken branch and the Python loop run, as in
the JAX package.

The reference wire format: an ``InputSpec`` feed list writes a
ProgramDesc ``.pdmodel`` through ``program_export``, and a ``.pdmodel``
whose first byte is ``0x0a`` loads through ``program_import``.  The
ProgramDesc construction calls (``program_guard``, ``data``, ...) raise,
as in the JAX package.
"""

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.tensor import Tensor, _wrap
from ..framework.mode import is_traced

class InputSpec:
    """reference paddle.static.InputSpec."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, str(tensor.dtype), name=name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Save a model for inference (reference:
    python/paddle/static/io.py:442).

    Two formats, selected by ``feed_vars``:

    - a non-empty list of InputSpec: write the REFERENCE wire format
      (``.pdmodel`` ProgramDesc + ``.pdiparams`` combined stream) so the
      model can be handed to a reference deployment.  The model's traced
      program must translate onto the reference op set (see
      ``program_export``); otherwise this raises NotImplementedError
      naming the untranslatable op.
    - empty/None: serialize the Layer carried by ``fetch_vars`` via
      ``jit.save`` (loadable by ``inference.create_predictor`` and
      :func:`load_inference_model`)."""
    from ..jit import save as jit_save
    from ..nn.layer_base import Layer

    target = None
    for cand in ([fetch_vars] if not isinstance(fetch_vars, (list, tuple))
                 else fetch_vars):
        if isinstance(cand, Layer):
            target = cand
            break
    if target is None and isinstance(program, Layer):
        target = program
    if target is None:
        raise TypeError(
            "save_inference_model serializes a Layer (pass the model as "
            "fetch_vars); ProgramDesc graphs do not exist here — build "
            "with paddle_tpu_torch.jit.to_static instead.")
    specs = list(feed_vars or []) if isinstance(feed_vars,
                                                (list, tuple)) else []
    if specs:
        bad = [s for s in specs if not isinstance(s, InputSpec)]
        if bad:
            raise TypeError(
                f"feed_vars must be InputSpec entries for reference-"
                f"format export (got {type(bad[0]).__name__}); pass an "
                "empty feed_vars list for the native jit.save format")
        from .program_export import export_reference_inference_model

        export_reference_inference_model(path_prefix, specs, target)
        return
    jit_save(target, path_prefix)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Returns (program, feed_names, fetch_names) shaped like the
    reference (python/paddle/static/io.py:727).

    Two formats load here: this package's own ``jit.save`` artifacts,
    and the reference's serialized inference programs (``.pdmodel``
    ProgramDesc + ``.pdiparams`` combined stream), which translate op by
    op onto torch and run as one traced program (see
    ``static.program_import``)."""
    import os

    pdmodel = f"{path_prefix}.pdmodel"
    if os.path.exists(pdmodel):
        with open(pdmodel, "rb") as f:
            head = f.read(1)
        # the reference's .pdmodel is a ProgramDesc protobuf whose first
        # field (blocks, field 1, length-delimited) encodes as 0x0a; this
        # package's jit.save .pdmodel is a pickle (0x80): one byte routes
        if head == b"\x0a":
            from .program_import import load_reference_inference_model

            return load_reference_inference_model(path_prefix)
    from ..jit import load as jit_load

    layer = jit_load(path_prefix)
    return layer, ["x0"], ["out0"]


class Executor:
    """Runs callables (a TranslatedLayer or a to_static function)."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        if not callable(program):
            raise TypeError(
                "static.Executor runs callables (a loaded TranslatedLayer "
                "or to_static function); legacy ProgramDesc execution "
                "does not exist")
        feed = feed or {}
        # bind by feed NAME when the program declares its feed order:
        # the reference API accepts the feed dict in any key order
        names = getattr(program, "feed_names", None)
        if names:
            missing = sorted(set(names) - set(feed))
            if missing:
                raise ValueError(
                    f"feed is missing keys {missing} required by the "
                    f"program's declared feeds {list(names)}")
            unknown = sorted(set(feed) - set(names))
            if unknown:
                # the reference Executor warns and ignores feed names the
                # program doesn't consume (executor.py _check_feed)
                import warnings
                warnings.warn(
                    f"feed keys {unknown} are not consumed by this "
                    f"program (feeds: {list(names)}); ignoring them")
            vals = [feed[n] for n in names]
        else:
            vals = list(feed.values())
        args = [Tensor(v) if not isinstance(v, Tensor) else v
                for v in vals]
        out = program(*args)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return [np.asarray(o) for o in outs]


def _no_static(name):
    def stub(*a, **k):
        raise NotImplementedError(
            f"paddle.static.{name} builds ProgramDesc graphs, which this "
            "framework intentionally does not have; decorate with "
            "paddle_tpu_torch.jit.to_static to compile (the traced "
            "program owns the graph).")
    stub.__name__ = name
    return stub


program_guard = _no_static("program_guard")
default_main_program = _no_static("default_main_program")
default_startup_program = _no_static("default_startup_program")
data = _no_static("data")
Program = _no_static("Program")


# --------------------------------------------------- compiled control flow --

def _tensorize(x):
    """A Tensor, torch tensor or Python/numpy scalar as a torch tensor; a
    scalar becomes an ``aten.full`` node, never a tensor constant (a
    constant inside a ``cond`` or ``while_loop`` graph would be a fake
    tensor baked into it)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bool, int, float, np.generic)):
        return torch.full((), x, dtype=torch.as_tensor(x).dtype)
    return torch.as_tensor(x)


def _flat_out(out):
    """A branch or body's output as flat torch tensors and its
    structure (Tensor leaves kept whole)."""
    leaves, spec = pytree.tree_flatten(
        out, is_leaf=lambda x: isinstance(x, Tensor))
    return [_tensorize(x) for x in leaves], spec


def _pred(p):
    return p.to(torch.bool).reshape(())


def _free_tensors(run):
    """Run ``run()`` once in the current trace and return ``(its output,
    the traced tensors it read that existed before it ran)``: the free
    tensors (closures) of a branch or a loop.  ``torch.cond`` and
    ``while_loop`` trace their functions in a nested tracer that sees
    only their operands, so the free tensors ride along as operands
    (the functions ignore the positions: the nested tracer maps the
    very same tensor objects to its placeholders).  The pass's own
    nodes are dead and go when the trace's dead code is removed."""
    from torch.fx.experimental import proxy_tensor

    tracer = proxy_tensor.get_proxy_mode().tracer   # the innermost
    before = set(tracer.graph.nodes)
    out = run()
    free = {a for n in tracer.graph.nodes if n not in before
            for a in n.all_input_nodes if a in before}
    # a tensor the function returns as it is reads no node of its own
    for t in pytree.tree_leaves(out):
        pt = tracer.tensor_tracker.get(t) if isinstance(
            t, torch.Tensor) else None
        if pt is not None and pt.proxy.node in before:
            free.add(pt.proxy.node)
    tensors = [t for t, pt in list(tracer.tensor_tracker.items())
               if pt.proxy.node in free]
    return out, tensors


def cond(pred, true_fn, false_fn, name=None):
    """Data-dependent branch (reference static.nn.cond over
    conditional_block ops).

    Eager: the taken branch runs natively (autograd flows through it).
    Under a ``to_static`` trace: both branches trace into the
    ``torch.cond`` operator and one runs — the supported way to branch
    on tensor values inside a compiled function (a plain python ``if``
    on a traced tensor raises the trace guard).  The branches' outputs
    must match in structure, shape and dtype (``lax.cond``'s rule; a
    mismatch raises TypeError).  The branches are differentiable."""
    p = _tensorize(pred)
    if not is_traced(p):
        return true_fn() if bool(p) else false_fn()
    from torch._higher_order_ops.cond import cond_op

    specs, free = [], {}
    for fn in (true_fn, false_fn):
        (leaves, spec), tensors = _free_tensors(lambda: _flat_out(fn()))
        specs.append((spec, [(tuple(x.shape), x.dtype) for x in leaves]))
        free.update((id(t), t) for t in tensors)
    if specs[0] != specs[1]:
        raise TypeError(
            "true_fn and false_fn output must have identical structure, "
            f"shapes and dtypes (lax.cond's rule): {specs[0]} vs "
            f"{specs[1]}")

    def branch(fn):
        def run(*_free):
            # fresh tensors: a branch output may not alias an input
            return tuple(x.clone() for x in _flat_out(fn())[0])
        return run

    outs = cond_op(_pred(p), branch(true_fn), branch(false_fn),
                   tuple(free.values()))
    return pytree.tree_unflatten([_wrap(o) for o in outs], specs[0][0])


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Data-dependent loop (reference static.nn.while_loop over the
    while op).

    Eager: the python loop runs (unrolled on the tape, differentiable).
    Under a ``to_static`` trace: lowers to the ``while_loop`` operator
    (``torch._higher_order_ops``); loop_var shapes and dtypes must be
    loop-invariant and reverse-mode gradient through the traced loop is
    not supported (``lax.while_loop``'s limitations)."""
    vals = [_tensorize(v) for v in loop_vars]
    traced = any(is_traced(v) for v in vals)
    if not traced:
        out = _tensorize(cond_fn(*loop_vars))
        traced = is_traced(out)
        if not traced:
            vars_ = list(loop_vars)
            while bool(_tensorize(cond_fn(*vars_))):
                out = body_fn(*vars_)
                vars_ = list(out) if isinstance(out, (tuple, list)) \
                    else [out]
            return vars_
    from torch._higher_order_ops.while_loop import while_loop_op

    n = len(vals)

    def c(*vs):
        return _pred(_tensorize(cond_fn(*[_wrap(v) for v in vs[:n]])))

    def b(*vs):
        out = body_fn(*[_wrap(v) for v in vs[:n]])
        out = out if isinstance(out, (tuple, list)) else (out,)
        outs = [_tensorize(o) for o in out]
        if len(outs) != n or any(
                tuple(o.shape) != tuple(v.shape) or o.dtype != v.dtype
                for o, v in zip(outs, vs)):
            raise TypeError(
                "while_loop body must return the loop vars' shapes and "
                "dtypes (lax.while_loop's rule): "
                f"{[(tuple(v.shape), v.dtype) for v in vs[:n]]} -> "
                f"{[(tuple(o.shape), o.dtype) for o in outs]}")
        # fresh tensors: a body output may not alias an input
        return tuple(o.clone() for o in outs)

    free = {}
    for fn in (c, b):
        free.update((id(t), t) for t in _free_tensors(lambda: fn(*vals))[1]
                    if all(t is not v for v in vals))
    return [_wrap(v) for v in while_loop_op(c, b, tuple(vals),
                                            tuple(free.values()))]


class nn:
    """paddle.static.nn namespace (cond/while_loop; the rest of
    static.nn builds ProgramDesc graphs)."""

    cond = staticmethod(cond)
    while_loop = staticmethod(while_loop)
