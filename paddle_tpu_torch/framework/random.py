"""Global RNG state.

Port of ``paddle_tpu/framework/random.py``.  Paddle exposes a global
generator seeded by ``paddle.seed``.  The JAX package keeps one root key
and splits it per draw; the port keeps one explicit ``torch.Generator``
per device, all seeded by :func:`seed`, and every random op, dropout and
initializer draws from the generator of the device its result lives on.
A ``torch.Generator`` cannot reproduce a JAX key stream, so the two
packages agree on distributions, not on draws.

Models also hold generators of their own (GPT's dropout draws from the
one it was seeded with).  :func:`generators_of` finds every generator a
forward may draw from, for the callers that must replay a forward's
draws (``jit.TrainStep(remat=True)``, ``fleet.recompute``, the program
exporter).  Its walk, :func:`modules_of`, crosses between the two kinds
of tree: a Paddle ``Layer`` keeps a ``torch.nn.Module`` (or a Layer
held in a Module) as a plain attribute, outside its sublayers, and
the data-parallel, ZeRO and tensor-parallel wrappers hold the model
just so.
"""

import torch

_initial_seed = 0
_generators = {}


def seed(seed_val):
    """Reset the global RNG (paddle.seed parity): every device's
    generator restarts from ``seed_val``."""
    global _initial_seed
    _initial_seed = int(seed_val)
    _generators.clear()


def generator(device):
    """The global generator of ``device`` (created, seeded, at first
    use)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = _generators.get(device)
    if gen is None:
        gen = _generators[device] = torch.Generator(device=device)
        gen.manual_seed(_initial_seed)
    return gen


def get_rng_state(device):
    return generator(device).get_state()


def set_rng_state(state, device):
    generator(device).set_state(state)


def modules_of(*objs):
    """Every Paddle ``Layer`` and ``torch.nn.Module`` reachable from
    ``objs``, each once (by ``id``), in pre-order: a Layer's
    ``sublayers(include_self=True)``, a Module's ``modules()``, and,
    under each of those, the walk of any Layer or Module held as a plain
    attribute.  Other objects are skipped."""
    from ..nn.layer_base import Layer

    seen, out = set(), []

    def visit(obj):
        if isinstance(obj, torch.nn.Module):
            mods = obj.modules()
        elif isinstance(obj, Layer):
            mods = obj.sublayers(include_self=True)
        else:
            return
        for m in mods:
            if id(m) in seen:
                continue
            seen.add(id(m))
            out.append(m)
            for v in list(vars(m).values()):
                visit(v)

    for obj in objs:
        visit(obj)
    return out


def generators_of(*objs):
    """Every explicit ``torch.Generator`` a forward of ``objs`` may draw
    from: those held by the modules of :func:`modules_of`, and the
    global ones of :func:`generator`, each once."""
    found = {id(g): g for m in modules_of(*objs) for g in vars(m).values()
             if isinstance(g, torch.Generator)}
    found.update((id(g), g) for g in _generators.values())
    return list(found.values())
