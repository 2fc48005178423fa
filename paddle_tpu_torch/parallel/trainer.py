"""SpmdTrainStep: the hybrid-parallel (dp × pp × mp [+sp]) training step.

Port of ``paddle_tpu/parallel/trainer.py``.  The JAX step is one XLA
program over the fleet Mesh (embed under GSPMD, ``spmd_pipeline`` over
'pp', head and loss, ``jax.grad``, clip, update), the strategy living in
shardings and the compiler owning the collectives.  The port runs one
process a rank over a ``topology.RankMesh`` and writes those
collectives out:

- **placement**: the model is sliced over ``mp`` by
  ``spmd.shard_parameters`` (its modules then run Megatron's layers, and
  the decomposition's functions with them); the trainer keeps its own
  leaves of ``functional_decompose()["params"]``: the embeddings and the
  head whole over pp, and of the stacked blocks only this stage's
  ``num_layers // pp`` (the interleave permutation applied once first
  with ``virtual_pp``);
- **batch**: split over dp × sharding (the sharding group is extra data
  parallelism, as in the JAX step), this rank's block of dim 0;
- **forward**: the embeddings on every stage (stage 0's feeds the
  pipeline), ``pipeline.pipeline_stage`` over the stage's layers, the
  head and loss on the replicated output on every stage.  Every stage
  thus computes the tied head's share of the embedding gradient; the
  lookup's share exists on stage 0 only (its lookup runs on aliases of
  the embedding leaves) and is broadcast over pp and added, so every
  stage holds the whole gradient once;
- **gradients**: averaged over dp × sharding; under sequence
  parallelism the gradients of the parameters not split over mp (each a
  partial sum over the rank's sequence shard) all-reduced over mp;
- **clip**: ``ClipGradByGlobalNorm``'s norm over the whole model: each
  stage's blocks once, the mp-split gradients summed over mp, the
  replicated ones (and the embeddings and head, on stage 0 only)
  counted once;
- **optimizer state**: ZeRO-1 over ``zero_axis`` ("sharding" by default,
  "dp" when asked, none at ``zero_stage=0``): each rank of that group
  keeps the state of its block of every parameter (the first dim the
  parameter's JAX spec leaves unsharded, when it splits evenly), updates
  that block with the optimizer's own rule (``_apply``) and all-gathers
  the blocks, as ``distributed/sharding``'s ``os`` stage does;
- **scaler**: ``amp.scaler_apply`` with the found-inf flag made the
  world's before the scale update; a step any rank found non-finite is
  skipped everywhere;
- ``remat=True`` recomputes each block in the backward
  (``torch.utils.checkpoint``, the dropout generators reseeded inside).

``state_dict()`` gathers the parameters and the optimizer state whole,
in canonical layer order and the JAX layout; ``sync_to_model()`` writes
the parameters back into the (mp-sliced) model.
"""

import numpy as np
import torch

from ..distributed.fleet.meta_parallel import mp_layers
from ..distributed.fleet.topology import axis_group
from ..distributed.group import _ensure_default_group
from ..distributed.sharding import _all_reduce, _block, _gather_axis
from ..optimizer.clip import ClipGradByGlobalNorm
from .pipeline import (drain_sends, fold_seed, interleave_permutation,
                       pipeline_stage, _layer_scan)

GROUPS = ("embed", "blocks", "head")


def _axes_group(mesh, axes):
    """This rank's group over the ranks that differ only along ``axes``
    (every list created on every rank, in one order)."""
    axes = [a for a in axes if a in mesh.axis_names]
    idx = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in idx]
    arr = np.transpose(mesh.devices, rest + idx)
    n = int(np.prod([mesh.devices.shape[i] for i in idx])) if idx else 1
    me = None
    rank = _ensure_default_group().rank
    for row in arr.reshape(-1, n):
        g = axis_group([int(r) for r in row])
        if rank in row:
            me = g
    return me


def _spec(axes, ndim):
    spec = list(axes or ()) + [None] * ndim
    return tuple(spec[:ndim])


class _Leaf:
    """One trained leaf: its tensor, group, name, JAX spec (mesh axes a
    dim, the block leaves' led by "pp"), packed mp parts and ZeRO dim."""

    def __init__(self, group, name, tensor, axes, parts):
        self.group, self.name, self.t = group, name, tensor
        self.spec = _spec(axes, tensor.dim())
        self.parts = parts
        self.mp_split = "mp" in self.spec
        self.zdim = None


class SpmdTrainStep:
    """Hybrid-parallel train step for models exposing
    ``functional_decompose()`` (``models/gpt.py``, ``models/llama.py``).

    Usage::
        trainer = SpmdTrainStep(model, opt, mesh, n_microbatches=4)
        loss = trainer.step(input_ids, labels)
    """

    def __init__(self, model, optimizer, mesh, n_microbatches=1,
                 sequence_parallel=False, remat=False, zero_stage=1,
                 virtual_pp=1, scaler=None, zero_axis=None):
        from ..distributed.fleet import spmd

        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.n_microbatches = n_microbatches
        self.sequence_parallel = sequence_parallel
        self.remat = remat
        self.virtual_pp = int(virtual_pp)
        if zero_axis is None:
            zero_axis = "sharding"
        self.zero_axis = zero_axis if zero_stage else None
        self.scaler = scaler if (scaler is not None and scaler.is_enable()) \
            else None
        self.found_inf = None

        self.mp = mesh.axis_size("mp")
        self.pp = mesh.axis_size("pp")
        self.stage = max(mesh.coord("pp"), 0)
        if sequence_parallel and self.mp > 1:
            model.config.sequence_parallel = True
        spmd.shard_parameters(model, mesh)
        self.mp_group = mesh.group("mp") if self.mp > 1 else None
        self.pp_group = mesh.group("pp") if self.pp > 1 else None
        self.batch_group = _axes_group(mesh, ("dp", "sharding"))
        zn = mesh.axis_size(self.zero_axis) if self.zero_axis else 1
        self.zero_group = mesh.group(self.zero_axis) if zn > 1 else None

        d = model.functional_decompose()
        self.fns = d["fns"]
        self.num_layers = d["num_layers"]
        params, specs = d["params"], d["specs"]
        self._layer_perm = None
        if self.virtual_pp > 1 and self.pp > 1:
            self._layer_perm = interleave_permutation(
                self.num_layers, self.pp, self.virtual_pp)
        n = self.num_layers // self.pp
        perm = (np.arange(self.num_layers) if self._layer_perm is None
                else self._layer_perm)[self.stage * n:(self.stage + 1) * n]
        parts = {}
        for name, p in model.named_parameters():
            for k in params["blocks"]:
                if name.endswith(".0." + k) and k not in parts:
                    parts[k] = getattr(p, "mp_parts", None)
        self.leaves = []
        self.params = {}
        for g in GROUPS:
            self.params[g] = {}
            for k, v in params[g].items():
                if g == "blocks":
                    v = v[torch.as_tensor(perm, device=v.device)]
                t = v.detach().clone().requires_grad_(True)
                self.params[g][k] = t
                self.leaves.append(_Leaf(g, k, t, specs[g].get(k),
                                         parts.get(k) if g == "blocks"
                                         else None))
        for leaf in self.leaves:
            leaf.zdim = self._zero_dim(leaf)
        self.device = self.leaves[0].t.device
        gens = getattr(self.fns[1], "generators", [])
        self._generators = [g for g, _ in gens]
        self._seed = gens[0][0].initial_seed() if gens else 0
        self._opt_state = {}
        if self.scaler is not None:
            from ..amp import scaler_init_state
            self.scaler._compiled_state = scaler_init_state(self.scaler,
                                                            self.device)
        self._step_count = 0

    # ---- placement ----
    def _zero_dim(self, leaf):
        """The dim ZeRO slices ``leaf``'s optimizer state along: the
        first its spec leaves unsharded (the JAX ``_shard_opt_state_
        spec``), if it splits evenly over the group."""
        if self.zero_group is None:
            return None
        n = self.zero_group.nranks
        for i, s in enumerate(leaf.spec):
            if s is None:
                return i if leaf.t.shape[i] % n == 0 else None
        return None

    def _local(self, x):
        """This rank's block of dim 0 over dp × sharding, on the device."""
        from ..core.tensor import Tensor

        x = x._data if isinstance(x, Tensor) else x
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device)
        if not x.is_floating_point():
            x = x.long()
        g = self.batch_group
        if g is None or g.nranks == 1:
            return x
        k = x.shape[0] // g.nranks
        return x[g.rank * k:(g.rank + 1) * k]

    def _block_fn(self):
        blk = self.fns[1]
        if not self.remat:
            return blk

        def remat_block(p, h):
            return blk(p, h)

        remat_block.generators = getattr(blk, "generators", [])
        remat_block.remat = True
        return remat_block

    # ---- the step ----
    def _forward(self, ids, labels):
        embed_fn, _, head_fn, loss_fn = self.fns
        blk = self._block_fn()
        seed = fold_seed(self._seed, self._step_count)
        for g in self._generators:
            g.manual_seed(fold_seed(seed, 2 ** 31))
        embed = self.params["embed"]
        alias = None
        if self.stage == 0:
            alias = {k: v.detach().requires_grad_(True)
                     for k, v in embed.items()}
            h = embed_fn(alias, ids)
        else:
            with torch.no_grad():
                h = embed_fn(embed, ids)
        blocks = self.params["blocks"]
        if self.pp == 1:
            h = _layer_scan(blk, h, blocks, seed)
        else:
            m = self.n_microbatches
            assert h.shape[0] % m == 0, \
                f"batch {h.shape[0]} not divisible by microbatches {m}"
            if self.virtual_pp > 1:
                assert m % self.pp == 0, \
                    (f"interleaved schedule needs n_microbatches ({m}) "
                     f"divisible by pp ({self.pp})")
            x_micro = h.reshape((m, h.shape[0] // m) + tuple(h.shape[1:]))
            h = pipeline_stage(blk, blocks, x_micro, group=self.pp_group,
                               stage=self.stage, pp=self.pp,
                               virtual_pp=self.virtual_pp, seed=seed)
            h = h.reshape((-1,) + tuple(h.shape[2:]))
        logits = head_fn(self.params["head"], h, embed)
        return loss_fn(logits, labels), alias

    def _sync_grads(self, alias):
        """The lookup's share broadcast from stage 0 and added; the batch
        group's average; the sequence-parallel mp sum."""
        embed = self.params["embed"]
        if self.pp > 1:
            names = list(embed)
            if self.stage == 0:
                share = [alias[k].grad if alias[k].grad is not None else
                         torch.zeros_like(alias[k]) for k in names]
            else:
                share = [torch.zeros_like(embed[k]) for k in names]
            flat = mp_layers.broadcast(
                torch.cat([s.reshape(-1) for s in share]), self.pp_group)
            off = 0
            for k in names:
                t = embed[k]
                part = flat[off:off + t.numel()].view_as(t)
                off += t.numel()
                t.grad = part.clone() if t.grad is None else t.grad + part
        elif alias is not None:
            for k, t in embed.items():
                gr = alias[k].grad
                if gr is not None:
                    t.grad = gr if t.grad is None else t.grad + gr
        leaves = [lf for lf in self.leaves if lf.t.grad is not None]
        g = self.batch_group
        if g is not None and g.nranks > 1:
            for lf, avg in zip(leaves, _all_reduce(g, [lf.t.grad for lf in
                                                       leaves])):
                lf.t.grad = avg
        if self.mp_group is not None and getattr(
                self.model.config, "sequence_parallel", False):
            repl = [lf for lf in leaves if not lf.mp_split]
            for lf, s in zip(repl, _all_reduce(
                    self.mp_group, [lf.t.grad for lf in repl], avg=False)):
                lf.t.grad = s

    def global_norm(self, grads):
        """The whole model's gradient norm (f32) from this rank's
        ``grads`` (one a leaf of ``self.leaves``)."""
        dev = self.device

        def sq(gs):
            if not gs:
                return torch.zeros((), dtype=torch.float32, device=dev)
            norms = torch._foreach_norm(gs, 2, dtype=torch.float32)
            return torch.sum(torch.stack(norms) ** 2)

        mine = [(lf, g) for lf, g in zip(self.leaves, grads)
                if lf.group == "blocks" or self.stage == 0]
        split = sq([g for lf, g in mine if lf.mp_split])
        repl = sq([g for lf, g in mine if not lf.mp_split])
        total = mp_layers.all_reduce(split, self.mp_group) + repl \
            if self.mp_group is not None else split + repl
        if self.pp_group is not None:
            total = mp_layers.all_reduce(total, self.pp_group)
        return torch.sqrt(total)

    def _clip(self, grads):
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        if not isinstance(clip, ClipGradByGlobalNorm):
            if self.mp > 1 or self.pp > 1:
                raise NotImplementedError(
                    f"{type(clip).__name__} under pp or mp (the hybrid "
                    "step clips by the global norm)")
            return clip._clip([lf.t for lf in self.leaves], grads)
        norm = self.global_norm(grads)
        scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def _update(self, grads):
        opt = self.optimizer
        opt._step_count += 1
        lr = opt.get_lr()
        grads = self._clip(grads)
        zg = self.zero_group
        r, n = (zg.rank, zg.nranks) if zg is not None else (0, 1)
        params, gs, states, owners = [], [], [], []
        for lf, g in zip(self.leaves, grads):
            p = lf.t
            if lf.zdim is not None:
                p, g = _block(p, lf.zdim, r, n), _block(g, lf.zdim, r, n)
            state = self._opt_state.get(id(lf))
            if state is None:
                state = self._opt_state[id(lf)] = opt._init_state(p)
            params.append(p)
            gs.append(g)
            states.append(state)
            owners.append(lf)
        if opt._weight_decay and not opt._decay_applied_in_rule():
            wd = float(opt._weight_decay)
            gs = [g + wd * p for g, p in zip(gs, params)]
        fun = getattr(opt, "_apply_decay_param_fun", None)
        saved = getattr(opt, "_decay_ids", None)
        if fun is not None:
            opt._decay_ids = {id(lf) for lf in owners if fun(lf.name)}
        try:
            opt._apply(params, gs, states, lr, owners)
        finally:
            if fun is not None:
                opt._decay_ids = saved
        for lf, p in zip(self.leaves, params):
            if lf.zdim is not None:
                lf.t.copy_(_gather_axis(zg, p, lf.zdim))

    @staticmethod
    def _reduce_found(found):
        """Whether any rank of the world found a non-finite gradient."""
        flag = found.to(torch.int32)
        return mp_layers.all_reduce(flag, _ensure_default_group(),
                                    "max").bool()

    def step(self, input_ids, labels):
        self._step_count += 1
        ids, lbl = self._local(input_ids), self._local(labels)
        for lf in self.leaves:
            lf.t.grad = None
        loss, alias = self._forward(ids, lbl)
        if self.scaler is None:
            loss.backward()
        else:
            state = self.scaler._compiled_state
            (loss * state["scale"].to(loss.dtype)).backward()
        drain_sends()
        self._sync_grads(alias)
        grads = [lf.t.grad if lf.t.grad is not None else
                 torch.zeros_like(lf.t) for lf in self.leaves]
        if self.scaler is None:
            self._update(grads)
        else:
            from ..amp import scaler_apply

            state = self.scaler._compiled_state
            grads, found, new_state = scaler_apply(
                self.scaler, state, grads, reduce_found=self._reduce_found)
            self.found_inf = found
            self.scaler._compiled_state = new_state
            if not bool(found):  # the step's one host read
                self._update(grads)
        loss = loss.detach()
        g = self.batch_group
        if g is not None and g.nranks > 1:
            loss = _all_reduce(g, [loss])[0]
        return loss

    __call__ = step

    # ---- gathering ----
    def _whole(self, lf, t, zero=False, mp=True):
        """``t`` (``lf``'s value or a state shaped like its local block)
        gathered over the ZeRO group (``zero``), mp (``mp``) and, for a
        block leaf, pp, in canonical layer order."""
        if zero and lf.zdim is not None:
            t = _gather_axis(self.zero_group, t, lf.zdim)
        if mp and lf.mp_split and self.mp_group is not None:
            t = mp_layers.whole_of(mp_layers.gather_list(t, self.mp_group),
                                   lf.spec, lf.parts)
        if lf.group == "blocks" and self.pp_group is not None:
            t = mp_layers.all_gather(t, self.pp_group, 0)
            if self._layer_perm is not None:
                inv = torch.as_tensor(np.argsort(self._layer_perm),
                                      device=t.device)
                t = t[inv]
        return t

    def _stacked(self, mp=True):
        """Every leaf gathered over pp (and mp with ``mp``)."""
        out = {g: {} for g in GROUPS}
        for lf in self.leaves:
            out[lf.group][lf.name] = self._whole(lf, lf.t.detach(), mp=mp)
        return out

    def sync_to_model(self):
        """Write the trained parameters into the model (its mp blocks)."""
        self.model.load_stacked(self._stacked(mp=False))

    def state_dict(self):
        opt = {g: {} for g in GROUPS}
        for lf in self.leaves:
            st = self._opt_state.get(id(lf)) or {}
            opt[lf.group][lf.name] = {
                k: (self._whole(lf, v, zero=True)
                    if isinstance(v, torch.Tensor) and v.dim() else v)
                for k, v in st.items()}
        return {"params": self._stacked(), "opt_state": opt,
                "step": self._step_count}
