"""Rank tasks of ``test_torch_parallel.py`` (``RankPool.run``).

Each function runs on every rank of a ``torch_dist_pool.RankPool`` and
returns picklable results (numpy); this module imports no JAX, so a
rank starts with torch and the port only.  The test holds the results
against the JAX package in the test process.
"""

import numpy as np
import torch


def _np(t):
    return t.detach().float().cpu().numpy()


def _gpt(sd, num_layers, **kw):
    from paddle_tpu_torch.models.gpt import gpt_tiny

    m = gpt_tiny(device="cpu", num_layers=num_layers, **kw)
    m.set_state_dict(sd)
    return m


def _llama(sd, num_layers):
    from paddle_tpu_torch.models.llama import llama_tiny

    m = llama_tiny(device="cpu", num_layers=num_layers)
    m.set_state_dict(sd)
    return m


def pipeline_task(sd, num_layers, x, mesh_kw, m, v):
    """``spmd_pipeline`` over ``build_mesh(**mesh_kw)`` on the decomposed
    eval-mode blocks: the output and, for loss = sum(out²), the gradients
    of the whole stack (only this stage's rows are nonzero) and of x."""
    from paddle_tpu_torch.distributed.fleet import build_mesh
    from paddle_tpu_torch.parallel import spmd_pipeline

    mesh = build_mesh(**mesh_kw)
    model = _gpt(sd, num_layers)
    model.eval()
    d = model.functional_decompose()
    block_fn = d["fns"][1]
    blocks = {k: t.clone().requires_grad_(True)
              for k, t in d["params"]["blocks"].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmd_pipeline(block_fn, blocks, xt, mesh=mesh, n_microbatches=m,
                        virtual_pp=v)
    (out * out).sum().backward()
    return {"out": _np(out), "stage": mesh.coord("pp"),
            "grads": {k: _np(t.grad) for k, t in blocks.items()},
            "dx": None if xt.grad is None else _np(xt.grad)}


def trainer_task(sd, num_layers, ids, labels, mesh_kw, kw, steps=3,
                 scaler=None, lr=1e-3, eps=1e-3, arch="gpt"):
    """``steps`` clipped AdamW steps of the port's tiny GPT (or Llama,
    ``arch="llama"``) through ``SpmdTrainStep(**kw)`` over
    ``build_mesh(**mesh_kw)``: the losses, the gathered state dict, this
    rank's optimizer-state shapes and its embedding leaves."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed.fleet import build_mesh
    from paddle_tpu_torch.parallel import SpmdTrainStep

    mesh = build_mesh(**mesh_kw)
    model = (_gpt if arch == "gpt" else _llama)(sd, num_layers)
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                          epsilon=eps,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    if scaler is not None:
        scaler = amp.GradScaler(**scaler)
    tr = SpmdTrainStep(model, opt, mesh, scaler=scaler, **kw)
    losses = [float(tr.step(ids, labels)) for _ in range(steps)]
    st = tr.state_dict()
    qkv = tr.params["blocks"][
        "attn.qkv.weight" if arch == "gpt" else "self_attn.qkv.weight"]
    m1 = tr._opt_state.get(id(next(lf for lf in tr.leaves
                                    if lf.t is qkv)), {}).get("moment1")
    tr.sync_to_model()
    return {"losses": losses,
            "params": {g: {k: _np(v) for k, v in sub.items()}
                       for g, sub in st["params"].items()},
            "moment1": {g: {k: _np(s["moment1"]) for k, s in sub.items()
                            if s} for g, sub in st["opt_state"].items()},
            "m1_local": None if m1 is None else tuple(m1.shape),
            "qkv_local": tuple(qkv.shape),
            "embed": {k: _np(v) for k, v in tr.params["embed"].items()},
            "found_inf": None if tr.found_inf is None
            else bool(tr.found_inf),
            "scale": None if scaler is None else scaler.get_scale(),
            "model_ln_f": _np(model.gpt.ln_f.weight if arch == "gpt"
                              else model.llama.norm.weight)}


# ----------------------------------------------------------------- MoE --
def moe_task(sd, xs, dys, gate, top_k, capacity_factor):
    """An expert-parallel ``MoELayer`` over the world (each rank its
    ``E/n`` experts of ``sd`` and its own tokens ``xs[rank]``): the
    output, aux loss and, for sum(out * dys[rank]), the gradients of the
    rank's parameters and of x; then the MoE clip's norm over the group
    next to the dense one."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, MoELayer)

    rank, world = dist.get_rank(), dist.get_world_size()
    group = dist.new_group(list(range(world)))
    e = sd["w1"].shape[0]
    layer = MoELayer(d_model=sd["w1"].shape[1], d_hidden=sd["w1"].shape[2],
                     num_experts=e, gate=gate, top_k=top_k,
                     capacity_factor=capacity_factor, group=group)
    k = e // world
    layer.set_state_dict({n: paddle.to_tensor(
        v if n == "gate_weight" else v[rank * k:(rank + 1) * k])
        for n, v in sd.items()})
    layer.eval()
    x = paddle.to_tensor(xs[rank], stop_gradient=False)
    out = layer(x)
    (out * paddle.to_tensor(dys[rank])).sum().backward()
    params = list(layer.parameters())
    clip = ClipGradForMOEByGlobalNorm(1.0, moe_group=group)
    grads = [p._data.grad for p in params]
    norm = clip.global_norm([p._data for p in params], grads)
    return {"out": _np(out._data), "aux": float(layer.l_aux),
            "dx": _np(x.grad._data), "norm": float(norm),
            "grads": {n: _np(p._data.grad)
                      for n, p in layer.named_parameters()}}


# ------------------------------------------- dataset, inference, BN --
def dataset_shuffle_task(paths, seed):
    """fleet's ``InMemoryDataset.global_shuffle`` with the rank and world
    size from the port's process group (the launcher's variables unset
    for the call): this rank's records."""
    import os

    from paddle_tpu_torch.distributed.fleet import InMemoryDataset

    saved = {k: os.environ.pop(k) for k in ("PADDLE_TRAINER_ID",
                                            "PADDLE_TRAINERS_NUM")
             if k in os.environ}
    try:
        ds = InMemoryDataset()
        ds.init(batch_size=2, use_var=[("slot_a", "sparse"),
                                       ("slot_b", "sparse"),
                                       ("label", "dense")])
        ds.set_filelist(paths)
        ds.load_into_memory()
        ds.global_shuffle(seed=seed)
        return [np.concatenate([np.asarray(v, np.float64).ravel()
                                for v in rec]) for rec in ds._records]
    finally:
        os.environ.update(saved)


def dist_inference_task(sd, x):
    """A Predictor over a small MLP with ``enable_dist_inference`` over
    dp = world: the outputs of the whole batch on every rank."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, nn
    from paddle_tpu_torch.distributed.fleet import build_mesh

    paddle.seed(0)
    net = nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in sd.items()})
    from paddle_tpu_torch.distributed import get_world_size
    cfg = inference.Config()
    cfg.set_model_obj(net)
    cfg.enable_dist_inference(build_mesh(dp=get_world_size()), "dp")
    pred = inference.create_predictor(cfg)
    return pred.run([x])[0]


def sync_bn_task(idx, vals, shape, dy):
    """The sparse ``SyncBatchNorm`` over the world in training, each rank
    its own sparse batch ``idx[rank]``/``vals[rank]``: the output values,
    the running stats and, for sum(out * dy[rank]), the gradients of the
    values, weight and bias."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist, sparse

    r = dist.get_rank()
    paddle.seed(0)
    bn = sparse.nn.SyncBatchNorm(vals[r].shape[1])
    bn.train()
    v = paddle.to_tensor(vals[r], stop_gradient=False)
    x = sparse.sparse_coo_tensor(paddle.to_tensor(idx[r].T), v, shape[r])
    out = bn(x)
    (out.values() * paddle.to_tensor(dy[r])).sum().backward()
    return {"out": _np(out.values()._data), "dv": _np(v.grad._data),
            "dw": _np(bn.weight.grad._data), "db": _np(bn.bias.grad._data),
            "mean": _np(bn._mean._data), "var": _np(bn._variance._data)}

