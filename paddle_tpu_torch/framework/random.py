"""Global RNG state.

Port of ``paddle_tpu/framework/random.py``.  Paddle exposes a global
generator seeded by ``paddle.seed``.  The JAX package keeps one root key
and splits it per draw; the port keeps one explicit ``torch.Generator``
per device, all seeded by :func:`seed`, and every random op, dropout and
initializer draws from the generator of the device its result lives on.
A ``torch.Generator`` cannot reproduce a JAX key stream, so the two
packages agree on distributions, not on draws.
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
