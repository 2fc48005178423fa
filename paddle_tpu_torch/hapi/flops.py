"""FLOPs counting (port of ``paddle_tpu/hapi/flops.py``; reference
python/paddle/hapi/dynamic_flops.py).

The JAX package asks XLA's ``cost_analysis`` of the compiled forward.
The port traces the forward over fake tensors into an ATen graph
(``framework.analysis.trace_graph``: nothing runs) and counts it with
the cost walker (``framework.cost.estimate_graph``), which follows
XLA's ``HloCostAnalysis`` conventions: two FLOPs a multiply-add of a
product or a convolution, one an output element of an elementwise op,
one an input element a reduction folds; transcendentals apart.  The
walker sees the unfused graph, where XLA counts what its optimiser
kept, so the two agree to within the elementwise work XLA folds
(``tests/test_torch_vision.py`` states the bound).
"""

import numpy as np
import torch


def flops(net, input_size, dtypes=None, print_detail=False):
    """Total forward FLOPs of ``net`` at ``input_size``.

    input_size: shape tuple (one input) or list of shape tuples.
    Returns an int (FLOPs for one forward pass).
    """
    from ..core.tensor import _wrap
    from ..framework.cost import estimate_fn
    from ..framework.dtype import convert_dtype

    shapes = [input_size] if isinstance(input_size[0], int) else \
        list(input_size)
    dtypes = dtypes or ["float32"] * len(shapes)
    params = list(net.parameters())
    device = params[0]._data.device if params else torch.device("cpu")
    examples = [torch.zeros(tuple(s), dtype=convert_dtype(d), device=device)
                for s, d in zip(shapes, dtypes)]

    was_training = net.training
    net.eval()
    try:
        def fn(*xs):
            with torch.no_grad():
                out = net(*(_wrap(x) for x in xs))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            return tuple(getattr(o, "_data", o) for o in outs)

        total = int(estimate_fn(fn, *examples).flops)
    finally:
        if was_training:
            net.train()

    if print_detail:
        n_params = sum(int(np.prod(p.shape)) for p in net.parameters())
        print(f"Total Flops: {total:,}    Total Params: {n_params:,}")
    return total
