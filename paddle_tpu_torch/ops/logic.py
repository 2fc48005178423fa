"""Comparison / logical / bitwise ops (paddle.tensor.logic parity).

Port of ``paddle_tpu/ops/logic.py``."""

import torch

from .registry import op


@op()
def equal(x, y):
    return torch.eq(x, y)

@op()
def not_equal(x, y):
    return torch.ne(x, y)

@op()
def greater_than(x, y):
    return torch.gt(x, y)

@op()
def greater_equal(x, y):
    return torch.ge(x, y)

@op()
def less_than(x, y):
    return torch.lt(x, y)

@op()
def less_equal(x, y):
    return torch.le(x, y)

@op()
def logical_and(x, y):
    return torch.logical_and(x, y)

@op()
def logical_or(x, y):
    return torch.logical_or(x, y)

@op()
def logical_xor(x, y):
    return torch.logical_xor(x, y)

@op()
def logical_not(x):
    return torch.logical_not(x)

@op()
def bitwise_and(x, y):
    return torch.bitwise_and(x, y)

@op()
def bitwise_or(x, y):
    return torch.bitwise_or(x, y)

@op()
def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)

@op()
def bitwise_not(x):
    return torch.bitwise_not(x)

@op()
def bitwise_left_shift(x, y):
    return torch.bitwise_left_shift(x, y)

@op()
def bitwise_right_shift(x, y):
    return torch.bitwise_right_shift(x, y)

@op()
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)
