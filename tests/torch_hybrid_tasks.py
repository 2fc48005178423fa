"""Rank tasks of the hybrid-parallel CPU tests (``RankPool.run``).

Each function runs on every rank of a ``torch_dist_pool.RankPool`` and
returns picklable results (numpy); this module imports no JAX, so a
rank starts with torch and the port only.  The tests hold the results
against the JAX package in the test process.
"""

import numpy as np
import torch


def _np(t):
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(t, Tensor):
        t = t._data
    return t.detach().float().cpu().numpy()


def _rank():
    from paddle_tpu_torch import distributed as dist
    return dist.get_rank(), dist.get_world_size()


def _strategy(dp=1, mp=1, pp=1, sharding=1, k_steps=1):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    if k_steps > 1:
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": k_steps, "avg": True}
    return s


# ------------------------------------------------------------ topology --
def hcg_task(dp, mp, pp=1, sharding=1):
    """fleet.init over the pool: the hcg's degrees, ranks, groups and a
    SUM over each axis group of (rank + 1)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers

    hcg = fleet.init(is_collective=True,
                     strategy=_strategy(dp, mp, pp, sharding))
    rank, _ = _rank()
    groups = {"data": hcg.get_data_parallel_group(),
              "model": hcg.get_model_parallel_group(),
              "pipe": hcg.get_pipe_parallel_group(),
              "sharding": hcg.get_sharding_parallel_group()}
    one = torch.tensor([float(rank + 1)])
    return {
        "mesh": dict(hcg.mesh.shape),
        "degrees": (hcg.get_data_parallel_world_size(),
                    hcg.get_model_parallel_world_size(),
                    hcg.get_pipe_parallel_world_size(),
                    hcg.get_sharding_parallel_world_size()),
        "ranks": (hcg.get_data_parallel_rank(),
                  hcg.get_model_parallel_rank(), hcg.get_stage_id(),
                  hcg.get_sharding_parallel_rank()),
        "groups": {k: list(g.ranks) for k, g in groups.items()},
        "sums": {k: float(mp_layers.all_reduce(one, g)[0])
                 for k, g in groups.items()},
        "src": (hcg.get_data_parallel_group_src_rank(),
                hcg.get_model_parallel_group_src_rank()),
        "mode": hcg.get_parallel_mode(),
        "global_rank": hcg.global_rank,
        "fleet": (fleet.worker_index(), fleet.worker_num(),
                  fleet.is_first_worker(), fleet.is_initialized(),
                  fleet.get_hybrid_communicate_group() is hcg),
    }


def build_mesh_task(kw):
    from paddle_tpu_torch.distributed import fleet

    try:
        m = fleet.build_mesh(**kw)
    except ValueError as e:
        return {"error": str(e)}
    return {"shape": dict(m.shape), "axes": m.axis_names,
            "devices": m.devices.tolist(),
            "coords": {a: m.coord(a) for a in m.axis_names}}


# ------------------------------------------------------ the mp layers --
def mp_layer_task(kind, weights, x, dy, mp=2):
    """One Paddle-API mp layer sliced over ``mp`` ranks from the whole
    ``weights``: (output, input gradient, weight gradients), each whole
    (gathered over the ranks)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import spmd
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
        mp_layers)

    mesh = fleet.build_mesh(mp=mp)
    g = mesh.group("mp")
    if kind.startswith("column"):
        layer = ColumnParallelLinear(*weights["weight"].shape,
                                     gather_output=kind == "column_gather")
    elif kind.startswith("row"):
        layer = RowParallelLinear(*weights["weight"].shape,
                                  input_is_parallel=kind == "row_parallel")
    else:
        layer = VocabParallelEmbedding(*weights["weight"].shape)
    layer.set_state_dict({k: paddle.to_tensor(v) for k, v in
                          weights.items()})
    spmd.shard_parameters(layer, mesh)
    if kind == "embedding":
        xt = paddle.to_tensor(x)
    else:
        local = x if kind != "row_parallel" else \
            mp_layers.block_of(x, (None, None, "mp"), None, g.rank,
                               g.nranks)
        xt = paddle.to_tensor(np.ascontiguousarray(local),
                              stop_gradient=False)
    out = layer(xt)
    want_local = kind == "column"
    up = torch.from_numpy(dy)
    if want_local:
        up = mp_layers.block_of(up, (None, None, "mp"), None, g.rank,
                                g.nranks)
    (out._data * up).sum().backward()
    res = {"out": out._data.detach()}
    if want_local:
        res["out"] = mp_layers.all_gather(res["out"].contiguous(), g, -1)
    if kind != "embedding":
        dx = xt.grad._data
        if kind == "row_parallel":
            dx = mp_layers.all_gather(dx.contiguous(), g, -1)
        res["dx"] = dx
    for name, p in layer.named_parameters():
        grad = p.grad._data
        axes, parts = mp_layers.param_spec(p)
        if mp_layers.mp_dim(axes) is not None:
            grad = mp_layers.all_gather(grad.contiguous(), g,
                                        mp_layers.mp_dim(axes))
        res["d" + name] = grad
    return {k: _np(v) for k, v in res.items()}


def parallel_xent_task(logits, labels, mp=2):
    """ParallelCrossEntropy over the rank's vocab block of ``logits``:
    the per-row losses and the whole logits' gradient of their mean."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import spmd
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ParallelCrossEntropy, mp_layers)

    mesh = fleet.build_mesh(mp=mp)
    g = mesh.group("mp")
    layer = ParallelCrossEntropy()
    spmd.shard_parameters(layer, mesh)
    local = mp_layers.block_of(logits, (None, "mp"), None, g.rank, g.nranks)
    x = paddle.to_tensor(np.ascontiguousarray(local), stop_gradient=False)
    loss = layer(x, paddle.to_tensor(labels))
    loss.mean().backward()
    dx = mp_layers.all_gather(x.grad._data.contiguous(), g, -1)
    return {"loss": _np(loss._data), "dx": _np(dx)}


# -------------------------------------------------- training the models --
def _build(model, sd, **kw):
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.models.llama import llama_tiny

    make = {"gpt": gpt_tiny, "llama": llama_tiny}[model]
    m = make(device="cpu", num_layers=2, **kw)
    m.set_state_dict(sd)
    return m


def train_task(model, sd, ids, labels, mp=1, dp=1, sp=False, steps=3,
               lr=1e-3, eps=1e-3, clip=1.0, dropout=0.0, grads=False,
               k_steps=1):
    """``steps`` AdamW steps of the port's tiny ``model`` from the whole
    state dict ``sd`` through fleet.init(dp, mp) → distributed_model →
    distributed_optimizer, each dp rank taking its block of the batch.
    With ``k_steps`` > 1 the strategy merges the gradients of ``k_steps``
    calls (``gradient_merge``), and ``ids``/``labels`` hold one batch a
    call ([calls, b, t], taken in turn).  Returns the local losses, the
    gathered weights (JAX layout), each replicated parameter's local
    value, the hybrid global norm of the first update and, with
    ``grads``, the first update's gradients as the inner optimizer sees
    them (gathered, after the dp average and the sequence-parallel sync;
    run with ``clip=None`` so none is scaled)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import spmd
    from paddle_tpu_torch.distributed.fleet.hybrid_parallel_optimizer \
        import HybridParallelOptimizer
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers

    hcg = fleet.init(is_collective=True,
                     strategy=_strategy(dp=dp, mp=mp, k_steps=k_steps))
    kw = dict(sequence_parallel=sp)
    if model == "gpt":
        kw.update(hidden_dropout_prob=dropout,
                  attention_probs_dropout_prob=dropout)
    net = _build(model, sd, **kw)
    tp = fleet.distributed_model(net)
    opt = optimizer.AdamW(
        learning_rate=lr, parameters=tp.parameters(), epsilon=eps,
        grad_clip=None if clip is None else
        optimizer.ClipGradByGlobalNorm(clip))
    opt = fleet.distributed_optimizer(opt)
    hpo = opt          # under the gradient merge, when there is one
    while not isinstance(hpo, HybridParallelOptimizer):
        hpo = hpo._inner
    batches = [(ids, labels)] if ids.ndim == 2 else list(zip(ids, labels))
    batches = [spmd.shard_batch((torch.from_numpy(np.ascontiguousarray(x)),
                                 torch.from_numpy(np.ascontiguousarray(y))),
                                hcg.mesh) for x, y in batches]
    seen = {}
    inner_step = hpo._inner_opt.step
    whole_norm = hpo.global_norm

    def norm_hook(group):
        # the first step's norm, before the clip scales the gradients
        value = whole_norm(group)
        seen.setdefault("norm", float(value))
        return value

    def capture():
        if "grads" not in seen:
            g = hcg.get_model_parallel_group()
            seen.setdefault("norm", float(whole_norm(g)))
            if grads:
                seen["grads"] = {}
                for name, p in net.named_parameters():
                    gr = p.grad
                    axes, parts = mp_layers.param_spec(p)
                    if mp_layers.mp_dim(axes) is not None and mp > 1:
                        gr = mp_layers.whole_of(
                            [b for b in _gather_blocks(gr, g)], axes,
                            parts)
                    seen["grads"][name] = _np(gr)
            else:
                seen["grads"] = None
        inner_step()

    hpo._inner_opt.step = capture
    hpo.global_norm = norm_hook
    losses = []
    for i in range(steps):
        ids, labels = batches[i % len(batches)]
        loss = net.loss(tp(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    weights = {k: _np(v) for k, v in tp.state_dict().items()} \
        if hasattr(tp, "_hcg") else \
        {k: _np(v) for k, v in net.named_parameters()}
    replicated = {n: _np(p) for n, p in net.named_parameters()
                  if "mp" not in (getattr(p, "mesh_axes", None) or ())}
    return {"losses": losses, "weights": weights, "replicated": replicated,
            "norm": seen.get("norm"), "grads": seen.get("grads"),
            "sp_marked": sorted(n for n, p in net.named_parameters()
                                if getattr(p, "sequence_parallel", False))}


def partial_grads_task(sd, ids, labels):
    """One backward of the SP-sliced gpt_tiny at mp = 2 without the
    optimizer: each rank's own gradients of the replicated parameters
    (the partial sums over its sequence half)."""
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_strategy(mp=2))
    net = _build("gpt", sd, sequence_parallel=True)
    tp = fleet.distributed_model(net)
    net.loss(tp(torch.from_numpy(ids)), torch.from_numpy(labels)).backward()
    return {n: _np(p.grad) for n, p in net.named_parameters()
            if getattr(p, "sequence_parallel", False)}


def _gather_blocks(t, g):
    from torch import distributed as dist

    buf = t.detach().contiguous()
    out = [torch.empty_like(buf) for _ in range(g.nranks)]
    dist.all_gather(out, buf, group=g.process_group)
    return out


def rank_block_task(sd):
    """Rank r's blocks of the whole state dict through the weights'
    function, against the blocks TensorParallel sliced the model to."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers

    hcg = fleet.init(is_collective=True, strategy=_strategy(mp=2))
    net = _build("gpt", sd)
    specs = mp_layers.model_specs(net)
    fleet.distributed_model(net)
    want = mp_layers.rank_state(sd, specs, hcg.get_model_parallel_rank(),
                                2)
    got = {n: _np(p) for n, p in net.named_parameters()}
    return {n: bool(np.array_equal(got[n], want[n])) for n in got}


def save_tp_task(sd, path):
    """TensorParallel's state_dict saved with the port's paddle.save by
    rank 0; returns the names, and whether ``set_state_dict`` of that
    whole state into a model perturbed first gives the blocks back."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_strategy(mp=2))
    net = _build("gpt", sd)
    tp = fleet.distributed_model(net)
    state = tp.state_dict()
    rank, _ = _rank()
    if rank == 0:
        paddle.save(state, path)
    blocks = {n: p.detach().clone() for n, p in net.named_parameters()}
    # the state's replicated entries are the live parameters, as a
    # Layer's state_dict gives them: keep a copy before the perturbation
    saved = {k: v._data.clone() for k, v in state.items()}
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(0.5)
    tp.set_state_dict(saved)
    back = all(torch.equal(p, blocks[n]) for n, p in net.named_parameters())
    return sorted(state), back


# ------------------------------------------- sequence / context parallel --
def cp_attention_task(q, k, v, mode, causal, sep=2, direct=False):
    """context_parallel_attention over build_mesh(sep=) on the global
    q/k/v (or, with ``direct``, ring/ulysses on the rank's chunks): the
    output and the gradients of sum(sin(out)), whole."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        context_parallel_attention, mp_layers, ring_attention,
        ulysses_attention)

    mesh = fleet.build_mesh(sep=sep)
    g = mesh.group("sep")
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    try:
        if direct:
            fn = {"ring": ring_attention, "ulysses": ulysses_attention}[mode]
            chunks = [mp_layers.split(t.detach(), g, 1).requires_grad_(True)
                      for t in ts]
            out = fn(*chunks, g, is_causal=causal)
            torch.sin(out).sum().backward()
            return {"out": _np(mp_layers.all_gather(out.detach(), g, 1)),
                    **{f"d{n}": _np(mp_layers.all_gather(c.grad, g, 1))
                       for n, c in zip("qkv", chunks)}}
        out = context_parallel_attention(*ts, mesh, axis="sep", mode=mode,
                                         is_causal=causal)
    except ValueError as e:
        return {"error": str(e)}
    torch.sin(out).sum().backward()
    return {"out": _np(out), **{f"d{n}": _np(t.grad)
                                for n, t in zip("qkv", ts)}}


def gpt_cp_task(sd, ids, mode, train):
    """gpt_tiny(cp_mode=mode) from ``sd`` under use_mesh(build_mesh(sep=2)):
    the logits (eval) or the loss and every parameter's gradient (train,
    dropout 0)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.spmd import use_mesh

    net = _build("gpt", sd, cp_mode=mode)
    ids = torch.from_numpy(ids)
    with use_mesh(fleet.build_mesh(sep=2)):
        if not train:
            net.eval()
            with torch.no_grad():
                return {"logits": _np(net(ids))}
        loss = net.loss(net(ids), ids)
        loss.backward()
    return {"loss": float(loss),
            "grads": {n: _np(p.grad) for n, p in net.named_parameters()}}


def seq_marks_task(x):
    """mark_sequence_sharded then mark_replicated over build_mesh(mp=2):
    the chunk, the round trip, and the gradient of sum(chunk * 2)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        mark_replicated, mark_sequence_sharded)
    from paddle_tpu_torch.distributed.fleet.spmd import use_mesh

    t = torch.from_numpy(x).requires_grad_(True)
    with use_mesh(fleet.build_mesh(mp=2)):
        chunk = mark_sequence_sharded(t, axis="mp", seq_dim=1)
        back = mark_replicated(chunk, axis="mp", seq_dim=1)
    (back * 2).sum().backward()
    return {"chunk": _np(chunk), "back": _np(back), "grad": _np(t.grad)}


# -------------------------------------------------------- auto_parallel --
def auto_parallel_task(x):
    """shard_tensor / reshard / dtensor_from_fn / shard_op / shard_layer
    over a ProcessMesh of the pool's two ranks."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.auto_parallel import (
        Partial, ProcessMesh, Replicate, Shard, dtensor_from_fn, reshard,
        shard_layer, shard_op, shard_tensor)

    rank, _ = _rank()
    pm = ProcessMesh([0, 1], dim_names=["x"])
    t = paddle.to_tensor(x)
    a = shard_tensor(t, pm, placements=[Shard(0)])
    a_block = a.numpy()
    a_meta = (a.placements, a.global_shape, a.process_mesh == pm)
    # as in JAX, reshard gives the tensor itself its new placement
    b = reshard(a, pm, [Replicate()])
    c = reshard(shard_tensor(paddle.to_tensor(x), pm, [Replicate()]), pm,
                [Shard(1)])
    part = shard_tensor(paddle.to_tensor(x * (rank + 1)), pm, [Partial()])
    summed = reshard(part, pm, [Replicate()])
    spec = shard_tensor(paddle.to_tensor(x), pm, shard_spec=["x", None])
    fn = dtensor_from_fn(paddle.ones, pm, [Shard(0)], [4, 2])
    op = shard_op(lambda u, w: u @ w, pm, out_shard_specs=[["x", None]])
    prod = op(paddle.to_tensor(x), paddle.to_tensor(x.T.copy()))
    paddle.seed(rank)         # the ranks' layers start apart
    layer = nn.Linear(3, 2)
    shard_layer(layer, pm)
    return {"a": a_block, "a_meta": a_meta, "b": b.numpy(),
            "b_is_a": b is a, "c": c.numpy(), "summed": summed.numpy(),
            "spec": spec.numpy(), "fn": fn.numpy(), "prod": prod.numpy(),
            "layer": layer.weight.numpy(),
            "layer_meta": layer.weight.placements}


def engine_task(X, Y):
    """Engine.fit over the pool's two ranks (a ProcessMesh "dp"): the
    losses and the weights after one epoch of two steps."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.auto_parallel import (Engine,
                                                            ProcessMesh)
    from paddle_tpu_torch.io import TensorDataset

    paddle.seed(0)
    model = nn.Linear(4, 1)
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    eng = Engine(model=model, loss=lambda o, y: nn.functional.mse_loss(o, y),
                 optimizer=opt, process_mesh=ProcessMesh([0, 1],
                                                         dim_names=["dp"]))
    ds = TensorDataset([paddle.to_tensor(X), paddle.to_tensor(Y)])
    hist = eng.fit(ds, epochs=1, batch_size=8)
    return {"losses": hist.history["loss"], "w": model.weight.numpy(),
            "b": model.bias.numpy()}


# ------------------------------------------------------ meta optimizers --
def meta_optimizer_task():
    """LocalSGD (k = 2) and FP16AllReduce over the dp group of
    fleet.init's default topology (dp = the world), each rank on its own
    data."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        FP16AllReduceOptimizer, LocalSGDOptimizer)

    hcg = fleet.init(is_collective=True)
    group = hcg.get_data_parallel_group()
    rank, _ = _rank()
    x = paddle.to_tensor(np.random.RandomState(10 + rank).rand(8, 4)
                         .astype(np.float32))

    def model():
        paddle.seed(0)
        return nn.Linear(4, 1)

    out = {}
    m = model()
    opt = LocalSGDOptimizer(optimizer.SGD(learning_rate=0.1,
                                          parameters=m.parameters()),
                            k_steps=2, group=group)
    sync = opt._sync_params

    def record():
        out["localsgd_step2_local"] = m.weight.numpy()
        sync()

    opt._sync_params = record
    for i in range(2):
        (m(x) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
        if i == 0:
            out["localsgd_step1"] = m.weight.numpy()
    out["localsgd_step2"] = m.weight.numpy()

    m = model()
    out["w0"] = m.weight.numpy()
    opt = FP16AllReduceOptimizer(optimizer.SGD(learning_rate=0.1,
                                               parameters=m.parameters()),
                                 group=group)
    (m(x) ** 2).mean().backward()
    out["grad"] = m.weight.grad.numpy()
    opt.step()
    out["fp16_w"] = m.weight.numpy()
    return out


def refine_task():
    """ParallelTuner.refine over the pool's two ranks: gpt_tiny's top
    analytic candidates for two devices, timed where the world holds
    them."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.auto_parallel import (
        ClusterSpec, CostEstimator, ParallelTuner)
    from paddle_tpu_torch.models.gpt import gpt_tiny

    cluster = ClusterSpec(num_devices=2, hbm_bytes=1e12, flops_bf16=1e12,
                          ici_bandwidth=1e10)
    est = CostEstimator(cluster, n_params=1e6, flops_per_token=6e6,
                        tokens_per_batch=4 * 32, hidden_size=64,
                        num_layers=2)
    tuner = ParallelTuner(est, mp_limit=2, pp_limit=2, micro_options=(1,),
                          vpp_options=(1,))
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 128, (4, 32)))

    results = tuner.refine(
        model_factory=lambda: gpt_tiny(device="cpu", num_layers=2),
        optimizer_factory=lambda m: optimizer.AdamW(
            learning_rate=1e-3, parameters=m.parameters()),
        batch_factory=lambda cand: (ids, ids), top_k=8, steps=1)
    return [{k: r[k] for k in ("dp", "mp", "pp", "sp", "recompute",
                               "measured_step_time")} | (
        {"error": r["error"]} if "error" in r else {}) for r in results]


def dcn_task():
    """ClusterSpec.calibrate_dcn over the pool's default group (the fact
    of the JAX package's two-process DCN worker)."""
    from paddle_tpu_torch.distributed.auto_parallel import ClusterSpec

    spec = ClusterSpec(calibrate=False)
    default = spec.dcn_bandwidth
    measured = spec.dcn_measured
    bw = spec.calibrate_dcn(nbytes=1 << 20, iters=2)
    return {"before": (default, measured), "bw": bw,
            "after": (spec.dcn_bandwidth, spec.dcn_measured)}
