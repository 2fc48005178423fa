"""Op registry.

Port of ``paddle_tpu/ops/registry.py``: registration is a decorator over
a body written on torch tensors; autograd comes from torch as the body
runs (``dispatch.py``), and the registry doubles as the coverage table
against the inventory (``inventory.py``).  Each first registration is
validated against the reference YAML schema (``schema.py``), with the
documented divergences of ``schema_compat.py``, as in the JAX package.

``waiting.WAITING`` names the inventory ops the port has not registered
yet, by family; every inventory name is in ``OPS`` or there, never both,
and from ROADMAP A23b-2 every one is in ``OPS``.
"""

import functools
import inspect

from .dispatch import apply_op

OPS = {}


class OpSchemaError(TypeError):
    """Raised when a registered op's signature contradicts the reference
    YAML schema and no divergence is recorded in ops/schema_compat.py."""


def _validate_schema(name, body):
    """Validate ``body``'s signature against the reference YAML schema.

    Returns a {param: default} dict of schema defaults to auto-fill for
    params the implementation left default-less, or None.  Raises
    OpSchemaError when a required schema arg is neither accepted by the
    implementation nor covered by a documented divergence — this is what
    makes the schema the single source the reference's yaml is
    (paddle/phi/api/yaml/ops.yaml + api_gen.py role).
    """
    from .schema import get_schema
    from .schema_compat import SCHEMA_DIVERGENCES

    sch = get_schema(name)
    if sch is None:
        return None
    try:
        sig = inspect.signature(body)
    except (TypeError, ValueError):
        return None
    params = sig.parameters
    if any(p.kind in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
           for p in params.values()):
        return None
    div = SCHEMA_DIVERGENCES.get(name, {})
    renames = div.get("renames", {})
    dropped = set(div.get("dropped", ()))
    missing = []
    fill = {}
    for entry in sch["args"]:
        a_name, has_default = entry[1], entry[2]
        default = entry[3] if len(entry) > 3 else None
        impl_name = renames.get(a_name, a_name)
        if impl_name not in params:
            if not has_default and a_name not in dropped:
                missing.append(a_name)
            continue
        p = params[impl_name]
        if (has_default and default is not None
                and p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)):
            fill[impl_name] = default
    if missing:
        raise OpSchemaError(
            f"op '{name}': implementation signature {list(params)} is "
            f"missing required schema arg(s) {missing} "
            f"(reference paddle/phi/api/yaml). Rename the params to match, "
            f"or record the deliberate divergence in "
            f"paddle_tpu_torch/ops/schema_compat.py")
    return fill or None


class OpDef:
    __slots__ = ("name", "body", "user_fn", "tags")

    def __init__(self, name, body, user_fn, tags):
        self.name = name
        self.body = body
        self.user_fn = user_fn
        self.tags = tags


def op(opname=None, tags=()):
    """Register a body written on torch tensors as an eager op.

    The returned user-facing function accepts Tensors as arguments or in
    list arguments and returns Tensors; called with none, it is the body
    on raw torch tensors (``dispatch.apply_op``).
    """

    def deco(body):
        name = opname or body.__name__

        # Schema validation on the first registration only.
        fill = None
        if name not in OPS:
            fill = _validate_schema(name, body)
        if fill:
            # schema-supplied defaults for params the impl left bare:
            # positions precomputed so the hot path pays dict lookups only
            positions = {k: i for i, k in
                         enumerate(inspect.signature(body).parameters)}
            fill_pos = [(k, positions[k], v) for k, v in fill.items()]

            @functools.wraps(body)
            def user_fn(*args, **kwargs):
                kwargs.pop("name", None)
                for k, idx, v in fill_pos:
                    if len(args) <= idx and k not in kwargs:
                        kwargs[k] = v
                return apply_op(name, body, args, kwargs)
        else:
            @functools.wraps(body)
            def user_fn(*args, **kwargs):
                kwargs.pop("name", None)
                return apply_op(name, body, args, kwargs)

        # First registration wins.
        if name not in OPS:
            OPS[name] = OpDef(name, body, user_fn, tuple(tags))
        return user_fn

    return deco


def raw(name):
    """The body of a registered op, on raw torch tensors."""
    return OPS[name].body


def register_external(name, user_fn, body=None, tags=()):
    """Register an already-wrapped user-facing function under ``name``.

    For ops whose public entry point lives outside the ``@op`` decorator
    (creation and random functions returning Tensors directly).  Keeps
    the coverage table honest without forcing everything through
    ``apply_op``.
    """
    if name not in OPS:
        OPS[name] = OpDef(name, body, user_fn, tuple(tags))
    return user_fn


def coverage(yaml_names=None):
    """Return (registered, total, pct) against an op-name inventory."""
    if yaml_names is None:
        from .inventory import OP_INVENTORY
        yaml_names = OP_INVENTORY
    have = sum(1 for n in yaml_names if n in OPS)
    return have, len(yaml_names), 100.0 * have / max(1, len(yaml_names))


def schema(name):
    """Reference-YAML signature schema for an op (args/outputs/backward/
    inplace), or None."""
    from .schema import get_schema
    return get_schema(name)
