"""Static Hopper kernel lint: coverage, resources, bounds, races and the
registry contract of the port's hand-written CUDA kernels.

The port of ``paddle_tpu/framework/kernel_lint.py``, whose rules read a
``pallas_call``'s grid and block specs.  Here a kernel is a
``torch.library`` op (``ops/cuda/registry.py``), so
:func:`introspect_kernels` finds its nodes in a graph traced over fake
tensors (``analysis.trace_graph``: nothing runs) with their operand
shapes and dtypes, and :func:`launch_plan` says what the C launch sites
launch at those shapes — for each kernel of the launch its grid, threads
a block, dynamic shared bytes and the output tile each block writes —
mirroring ``ragged_attention.cu``'s ``launch`` (split kernel, combine),
``decode_attention.cu``'s, ``flash_attention.cu``'s ``launch_fwd`` /
``launch_bwd`` (f32 SIMT and bf16 tensor-core instances) and
``layernorm.cu``'s (``bwd_plan`` sizing the backward's row pass), with
``split_kv.plan`` and ``split_kv.ragged_slots``.  Each source's C
``*_info`` entry (:func:`card_resources`) reports, on the card, the same
launch's grid, threads and dynamic shared bytes, and the card's
registers, spills, static shared bytes and blocks an SM for it;
``chip_smoke.py``'s ``tooling`` phase holds the plan equal to the first
three and the resources within the profile.

Rule catalog:

- **K001 coverage** — the launches' grids cover every element of every
  output at the traced shapes (a block for every output tile).
- **K002 resources** — against the ``"h100"`` profile of
  ``framework/cost.py``: dynamic plus static shared memory a block at
  most 232448 bytes, threads a block at most 1024, registers a thread at
  most 255 and registers times threads within an SM's 65536, and at
  least one block resident an SM.  On the CPU what the plan alone knows
  is checked (dynamic shared memory, threads); the card's numbers join
  it in the smoke.
- **K003 bounds** — the split-KV plan covers every key a row or cache
  can hold (``splits * CHUNK >= P * bs``, ``>= S_max``), the ragged
  partials hold a slot for every tile the grid writes (``>= T``, or ``>=
  R * tile`` for the row layout, per token only within
  ``TOKEN_SCRATCH_BYTES`` unless T itself is that small), the block
  tables fit the engine's ``max_pages``, and no grid dimension past the
  card's limits.
- **K004 write races** — no two blocks of one launch write one element
  of a buffer, partials included (a split's partial has one writer; the
  combine reduces them).  A launch whose tiles depend on the
  descriptors' values (the ragged split kernel finds its tile by walking
  the rows) is checked by K003's slot count instead.
- **K005 registry contract** — checked on the CPU: every module under
  ``ops/cuda/`` that loads a library has a registry entry; each entry's
  plain version is callable, its parity file exists and defines a test
  that names the kernel, its source exists, its ``replaces`` points at a
  ``def`` under ``paddle_tpu/ops/pallas/`` that reaches ``pallas_call``,
  its op has CUDA, CPU and fake implementations, and ``chip_smoke.py``'s
  ``PARITY_PHASES`` covers it.

:func:`lint_registry` runs K005 and K001-K004 over every kernel instance
of an engine's bucket grid (traced) and the other main paths' shapes
(:data:`MAIN_PATH_SHAPES`: FMT and Llama decode, GPT-124M training, the
Conformer and gpt_6_7b's forward).
"""

import ast
import ctypes
import os

import numpy as np
import torch

from .analysis import ERROR, Finding, _want, trace_graph
from .cost import DEVICE_PROFILES

__all__ = [
    "KERNEL_RULES", "Launch", "KernelCall", "introspect_kernels",
    "launch_plan", "check_plan", "card_resources", "check_registry",
    "span", "engine_calls", "main_path_calls",
    "lint_registry", "MAIN_PATH_SHAPES",
]

KERNEL_RULES = ("K001", "K002", "K003", "K004", "K005")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# constants of the sources, mirrored (tests hold them to the .cu text)
SPLIT_THREADS = 128         # splitkv::kThreads
FLASH_SIMT = {"BQ": 64, "BK": 64, "threads": 256, "max_d": 128}
LN_FWD_WARPS = 4            # kFwdWarps in layernorm.cu
LN_RED_THREADS = 256        # kRedThreads in layernorm.cu
LN_RING_SLOTS = 2           # kRingSlots in layernorm.cu
GRID_YZ_MAX = 65535
GRID_X_MAX = 2 ** 31 - 1
# an SM count for plans made without a card (the H100 SXM's; the smoke
# passes the card's own)
NOMINAL_SMS = 132

# GPT-124M's and Llama-160M's shapes on the main paths other than the
# paged engine, as chip_smoke.py drives them: FMT's bf16 decode (batch 8,
# max_length 192), Llama's f32 decode (batch 8, a 2048-slot cache), and
# the O2 bf16 and float16 training steps at 8 x 1024 (flash attention
# causal, the LayerNorms over 8192 rows of 768).
MAIN_PATH_SHAPES = {
    "fmt_decode": ("decode_attention", dict(
        q=((8, 12, 64), torch.bfloat16),
        k_cache=((8, 192, 12, 64), torch.bfloat16))),
    "llama_decode": ("decode_attention", dict(
        q=((8, 12, 64), torch.float32),
        k_cache=((8, 2048, 4, 64), torch.float32))),
    "train_flash_fwd": ("flash_attention_fwd", dict(
        q=((8, 1024, 12, 64), torch.bfloat16),
        k=((8, 1024, 12, 64), torch.bfloat16))),
    "train_flash_bwd": ("flash_attention_bwd", dict(
        q=((8, 1024, 12, 64), torch.bfloat16),
        k=((8, 1024, 12, 64), torch.bfloat16))),
    "train_ln_fwd": ("layernorm_fwd", dict(
        x2d=((8192, 768), torch.bfloat16))),
    "train_ln_bwd": ("layernorm_bwd", dict(
        x2d=((8192, 768), torch.bfloat16))),
    # the same step in O2 float16 under loss scaling (the f16 instances)
    "train_fp16_flash_fwd": ("flash_attention_fwd", dict(
        q=((8, 1024, 12, 64), torch.float16),
        k=((8, 1024, 12, 64), torch.float16))),
    "train_fp16_flash_bwd": ("flash_attention_bwd", dict(
        q=((8, 1024, 12, 64), torch.float16),
        k=((8, 1024, 12, 64), torch.float16))),
    "train_fp16_ln_fwd": ("layernorm_fwd", dict(
        x2d=((8192, 768), torch.float16))),
    "train_fp16_ln_bwd": ("layernorm_bwd", dict(
        x2d=((8192, 768), torch.float16))),
    # the speech path's Conformer at its defaults, f32, 16 x 10 s (251
    # frames after subsampling): attention at head_dim 36, LayerNorms of
    # 144; gpt_6_7b's eval forward over 2 x 2048 tokens, bf16: attention
    # at D 128, the wide LayerNorm at 4096
    "conformer_flash_fwd": ("flash_attention_fwd", dict(
        q=((16, 251, 4, 36), torch.float32),
        k=((16, 251, 4, 36), torch.float32))),
    "conformer_flash_bwd": ("flash_attention_bwd", dict(
        q=((16, 251, 4, 36), torch.float32),
        k=((16, 251, 4, 36), torch.float32))),
    "conformer_ln_fwd": ("layernorm_fwd", dict(
        x2d=((4016, 144), torch.float32))),
    "conformer_ln_bwd": ("layernorm_bwd", dict(
        x2d=((4016, 144), torch.float32))),
    "gpt6_7b_flash_fwd": ("flash_attention_fwd", dict(
        q=((2, 2048, 32, 128), torch.bfloat16),
        k=((2, 2048, 32, 128), torch.bfloat16))),
    "gpt6_7b_ln_fwd": ("layernorm_fwd", dict(
        x2d=((4096, 4096), torch.bfloat16))),
}


# --------------------------------------------------------------------------
# introspection: op node -> KernelCall
# --------------------------------------------------------------------------
class KernelCall:
    """One kernel op node of a traced graph: the registry name, the
    node, and ``{operand name: (shape, dtype)}`` of its tensor operands
    (scalars by value)."""

    __slots__ = ("name", "node", "operands")

    def __init__(self, name, node, operands):
        self.name = name
        self.node = node
        self.operands = operands

    def __repr__(self):
        return f"KernelCall({self.name} {self.operands})"


def introspect_kernels(fn, *args):
    """Trace ``fn(*args)`` over fake tensors and return a
    :class:`KernelCall` per kernel op node, in graph order."""
    from ..ops.cuda import registry

    kernels = registry.by_op()
    calls = []
    for node in trace_graph(fn, *args).graph.nodes:
        entry = kernels.get(node.target)
        if entry is None:
            continue
        schema = node.target._schema
        operands = {}
        for arg, value in zip(schema.arguments, node.args):
            val = value.meta.get("val") if isinstance(value, torch.fx.Node) \
                else value
            operands[arg.name] = ((tuple(val.shape), val.dtype)
                                  if isinstance(val, torch.Tensor) else val)
        calls.append(KernelCall(entry.name, node, operands))
    return calls


# --------------------------------------------------------------------------
# launch plans
# --------------------------------------------------------------------------
class Launch:
    """One kernel of a launch plan.

    kernel   -- the C kernel (instance) name
    grid     -- (x, y, z) blocks
    threads  -- threads a block
    smem     -- dynamic shared bytes a block
    writes   -- {buffer: (shape, cover)}: ``cover(counts, grid)`` adds one
                to every element each block of ``grid`` writes (numpy),
                None where the tiles depend on the data
    partials -- buffers a later kernel of the launch reduces
    """

    __slots__ = ("kernel", "grid", "threads", "smem", "writes", "partials",
                 "static_smem", "regs", "local_bytes", "blocks_per_sm")

    def __init__(self, kernel, grid, threads, smem, writes, partials=()):
        self.kernel = kernel
        self.grid = tuple(grid) + (1,) * (3 - len(grid))
        self.threads = threads
        self.smem = smem
        self.writes = writes
        self.partials = tuple(partials)
        # from the card (card_resources), None until read there
        self.static_smem = self.regs = self.local_bytes = None
        self.blocks_per_sm = None

    def __repr__(self):
        return (f"Launch({self.kernel} grid={self.grid} "
                f"threads={self.threads} smem={self.smem})")


def span(counts, blocks, tile, stride=None, lead=None):
    """Block ``b < blocks`` writes elements ``[b * stride, b * stride +
    tile)`` of ``counts``' last axis (``stride`` defaults to ``tile``),
    for its first ``lead`` rows (default all): add one to each."""
    stride = tile if stride is None else stride
    n = counts.shape[-1]
    idx = (np.arange(blocks)[:, None] * stride
           + np.arange(tile)[None, :]).ravel()
    idx = idx[idx < n]
    rows = counts if lead is None else counts[:lead]
    if counts.ndim == 1:
        np.add.at(rows, idx, 1)
    else:
        np.add.at(rows, (slice(None), idx), 1)


# the split kernels' element-type names (f32 for anything else)
_SPLIT_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16"}


def _ragged_plan(q, k_pages, block_tables, quant=False):
    from ..ops.cuda import split_kv

    (t, nq, d), qdt = q
    (_, bs, nkv, _), _ = k_pages
    (r, p), _ = block_tables
    g = nq // nkv
    tile = split_kv.ROWS // g
    splits = split_kv.plan(p * bs)
    slots = split_kv.ragged_slots(t, r, nq, nkv, splits, d)
    tiles = min(t, -(-t // tile) + r - 1)
    per_t = -(-nq * d // SPLIT_THREADS)
    isz = 1 if quant else torch.empty((), dtype=qdt).element_size()
    tdt = _SPLIT_DTYPES.get(qdt, "f32")
    kv = "int8" if quant else tdt
    dl = 2 if d <= 64 else 4

    def out_cover(counts, grid):
        # block (token x, y) writes elements [y * 128, (y + 1) * 128)
        span(counts, grid[1], SPLIT_THREADS, lead=grid[0])

    split = Launch(f"ragged_split_kernel<{tdt},{kv},{dl}>",
                   (tiles, nkv * splits), SPLIT_THREADS,
                   _split_smem(isz, d, quant),
                   {"partials": ((slots * nq * splits,), None)},
                   partials=("partials",))
    combine = Launch(f"ragged_combine<{tdt}>", (t, per_t), SPLIT_THREADS, 0,
                     {"out": ((t, nq * d), out_cover)})
    return [split, combine], dict(splits=splits, slots=slots, tile=tile,
                                  tokens=t, rows=r, pages=p, block_size=bs,
                                  num_q_heads=nq, head_dim=d,
                                  keys=p * bs)


def _split_smem(itemsize, d, quant):
    """splitkv::smem_bytes<KV>(d): the two-stage K/V ring, q of the
    block's 16 rows in f32, and each warp's p of a stage's keys."""
    stage_keys = 4 * 16
    row = d * itemsize + 16
    stage = 2 * stage_keys * row + (2 * stage_keys * 4 if quant else 0)
    return 2 * stage + 16 * d * 4 + 4 * stage_keys * 16


def _decode_plan(q, k_cache):
    from ..ops.cuda import split_kv

    (b, nq, d), qdt = q
    (_, s_max, nkv, _), _ = k_cache
    g = nq // nkv
    splits = split_kv.plan(s_max)
    per_b = -(-nq * d // SPLIT_THREADS)
    isz = torch.empty((), dtype=qdt).element_size()
    tdt = _SPLIT_DTYPES.get(qdt, "f32")
    dl = 2 if d <= 64 else 4

    def part_cover(counts, grid):
        # block (kv head j, sequence, split) writes the partials of its
        # sequence's group-j query heads at its split
        c = counts.reshape(b, nkv, g, splits)
        c[:grid[1], :grid[0], :, :grid[2]] += 1

    def out_cover(counts, grid):
        span(counts, grid[1], SPLIT_THREADS, lead=grid[0])

    split = Launch(f"decode_split_kernel<{tdt},{dl}>", (nkv, b, splits),
                   SPLIT_THREADS, _split_smem(isz, d, False),
                   {"partials": ((b * nq * splits,), part_cover)},
                   partials=("partials",))
    combine = Launch(f"decode_combine<{tdt}>", (b, per_b), SPLIT_THREADS, 0,
                     {"out": ((b, nq * d), out_cover)})
    return [split, combine], dict(splits=splits, keys=s_max, batch=b)


def _tc_tiles(d):
    """(DP, BM, BN) of the bf16 and f16 tensor-core instances for head
    dim d."""
    if d <= 32:
        return 32, 64, 64
    if d <= 64:
        return 64, 64, 64
    return 128, 64, 32


def _simt_smem(kind, d):
    """fwd_smem / dq_smem / dkv_smem of flash_attention.cu (the dk/dv
    kernel also keeps its query tile's lse and delta, kBQ f32 each)."""
    pad = FLASH_SIMT["BQ"] + 4
    bq, bk = FLASH_SIMT["BQ"], FLASH_SIMT["BK"]
    if kind == "fwd":
        return 4 * (d * pad + 2 * bk * (d + 1) + bk * pad)
    if kind == "dq":
        return 4 * (2 * d * pad + 2 * bk * (d + 1) + bk * pad)
    return 4 * (2 * d * pad + 2 * bq * (d + 1) + 2 * bq * pad + 2 * bq)


def _rows(tile, bn_axis):
    """Cover of [B*N, seq] rows: block (b, n) x row tile writes ``tile``
    rows of its (b, n); ``bn_axis`` is the grid axis of (b, n) (0 for
    the tensor-core kernels, 1 for SIMT), the other one the row tiles."""
    def cover(counts, grid):
        span(counts, grid[1 - bn_axis], tile, lead=grid[bn_axis])
    return cover


# the tensor-core instances' element types, as the source names them
_TC_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16"}


def _flash_plan(q, k, backward):
    (b, sq, n, d), qdt = q
    (_, sk, _, _), _ = k
    bn = b * n
    if qdt in _TC_DTYPES:
        dp, bm, bnt = _tc_tiles(d)
        inst = f"<{_TC_DTYPES[qdt]},{dp},{bm},{bnt}>"
        rows = _rows(bm, 0)
        if not backward:
            return [Launch("flash_fwd_tc" + inst, (bn, -(-sq // bm)), bm * 2,
                           2 * dp * (bm + 4 * bnt),
                           {"out": ((bn, sq), rows),
                            "lse": ((bn, sq), rows)})], {}
        return [
            Launch("flash_dq_tc" + inst, (bn, -(-sq // bm)), bm * 2,
                   2 * dp * (3 * bm + 4 * bnt),
                   {"dq": ((bn, sq), rows), "delta": ((bn, sq), rows)}),
            Launch("flash_dkv_tc" + inst, (bn, -(-sk // bm)), bm * 2,
                   2 * dp * (2 * bm + 4 * bnt) + 16 * bnt,
                   {"dk": ((bn, sk), rows), "dv": ((bn, sk), rows)}),
        ], {}
    dc = 4 if d <= 64 else 8
    bq, bk, th = FLASH_SIMT["BQ"], FLASH_SIMT["BK"], FLASH_SIMT["threads"]
    if not backward:
        return [Launch(f"flash_fwd_kernel<f32,{dc}>", (-(-sq // bq), bn), th,
                       _simt_smem("fwd", d),
                       {"out": ((bn, sq), _rows(bq, 1)),
                        "lse": ((bn, sq), _rows(bq, 1))})], {}
    rows = bn * sq

    def delta_cover(counts, grid):
        span(counts, grid[0], 8)             # one warp a row, 8 a block

    return [
        Launch("delta_f32_kernel", (-(-rows // 8),), 256, 0,
               {"delta": ((rows,), delta_cover)}),
        Launch(f"flash_bwd_dq_kernel<f32,{dc}>", (-(-sq // bq), bn), th,
               _simt_smem("dq", d), {"dq": ((bn, sq), _rows(bq, 1))}),
        Launch(f"flash_bwd_dkv_kernel<f32,{dc}>", (-(-sk // bk), bn), th,
               _simt_smem("dkv", d),
               {"dk": ((bn, sk), _rows(bk, 1)),
                "dv": ((bn, sk), _rows(bk, 1))}),
    ], {}


def _ln_bwd_smem(itemsize, c):
    """bwd_smem<T, V>(C) of layernorm.cu: gamma f32, the warps' stats,
    then the larger of the rings and the f32 warp sums."""
    from ..ops.cuda import layernorm_kernel as lnk

    v = -(-c // 256)
    row_bytes = 2 * 256 * v * itemsize
    stages = (LN_RING_SLOTS if lnk.BWD_WARPS * LN_RING_SLOTS * row_bytes
              <= 192 * 1024 else 1)
    ring = lnk.BWD_WARPS * stages * 2 * c * itemsize
    red = lnk.BWD_WARPS * 2 * c * 4
    return c * 4 + lnk.BWD_WARPS * stages * 8 + max(ring, red)


def _ln_wide_plan(rows, c, tdt, backward, slots):
    """The wide-row launches (C above ``NARROW_C``): a block a row
    forward; one wave of blocks walking their rows backward, each
    writing its dx rows and one partial row, then the reduce."""
    from ..ops.cuda import layernorm_kernel as lnk

    v = lnk._instance(c)[1]
    if not backward:
        def rows_cover(counts, grid):
            span(counts, grid[0], 1)              # a block a row

        return [Launch(f"ln_fwd_wide_kernel<{tdt},{v}>", (rows,),
                       lnk.WIDE_THREADS, 0,
                       {"y": ((rows,), rows_cover),
                        "mu": ((rows,), rows_cover),
                        "rstd": ((rows,), rows_cover)})], dict(rows=rows)
    nparts, red_blocks = lnk.bwd_plan(rows, c, slots)

    def dx_cover(counts, grid):
        for blk in range(grid[0]):
            counts[blk * rows // grid[0]:(blk + 1) * rows // grid[0]] += 1

    return [
        Launch(f"ln_bwd_wide_kernel<{tdt},{v}>", (nparts,),
               lnk.WIDE_THREADS, 3 * c * 4,
               {"dx": ((rows,), dx_cover),
                "partials": ((nparts,), lambda n, g: span(n, g[0], 1))},
               partials=("partials",)),
        Launch("ln_reduce_kernel", (red_blocks,), LN_RED_THREADS, 0,
               {"dgdb": ((2 * c,),
                         lambda n, g: span(n, g[0], lnk.RED_COLS))}),
    ], dict(rows=rows, nparts=nparts)


def _ln_plan(x2d, backward, slots):
    from ..ops.cuda import layernorm_kernel as lnk

    (rows, c), dt = x2d
    tdt = {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dt, "f32")
    if c > lnk.NARROW_C:
        return _ln_wide_plan(rows, c, tdt, backward, slots)
    v = -(-c // 256)
    if not backward:
        def rows_cover(counts, grid):
            span(counts, grid[0], LN_FWD_WARPS)   # a warp a row

        return [Launch(f"ln_fwd_kernel<{tdt},{v}>",
                       (-(-rows // LN_FWD_WARPS),), LN_FWD_WARPS * 32, 0,
                       {"y": ((rows,), rows_cover),
                        "mu": ((rows,), rows_cover),
                        "rstd": ((rows,), rows_cover)})], dict(rows=rows)
    nparts, red_blocks = lnk.bwd_plan(rows, c, slots)
    isz = torch.empty((), dtype=dt).element_size()

    def dx_cover(counts, grid):
        # block b of the grid owns rows [b * rows // grid, (b + 1) * ...)
        for blk in range(grid[0]):
            counts[blk * rows // grid[0]:(blk + 1) * rows // grid[0]] += 1

    def part_cover(counts, grid):
        span(counts, grid[0], 1)          # block b writes partial row b

    def red_cover(counts, grid):
        span(counts, grid[0], lnk.RED_COLS)

    return [
        Launch(f"ln_bwd_kernel<{tdt},{v}>", (nparts,), lnk.BWD_WARPS * 32,
               _ln_bwd_smem(isz, c),
               {"dx": ((rows,), dx_cover),
                "partials": ((nparts,), part_cover)},
               partials=("partials",)),
        Launch("ln_reduce_kernel", (red_blocks,), LN_RED_THREADS, 0,
               {"dgdb": ((2 * c,), red_cover)}),
    ], dict(rows=rows, nparts=nparts)


def launch_plan(name, slots=None, **operands):
    """The launches of kernel ``name`` at ``operands`` (``{operand name:
    (shape, dtype)}`` as :class:`KernelCall` holds them) -> (launches,
    facts): a :class:`Launch` per kernel in launch order, and the plan's
    sizes the bounds rule reads.  ``slots`` is the LayerNorm backward's
    resident blocks (blocks an SM times SMs; default one a block on
    :data:`NOMINAL_SMS`)."""
    if name in ("paged_ragged_attention", "paged_ragged_attention_quant"):
        return _ragged_plan(operands["q"], operands["k_pages"],
                            operands["block_tables"],
                            quant=name.endswith("_quant"))
    if name == "decode_attention":
        return _decode_plan(operands["q"], operands["k_cache"])
    if name in ("flash_attention_fwd", "flash_attention_bwd"):
        return _flash_plan(operands["q"], operands["k"],
                           name.endswith("_bwd"))
    if name in ("layernorm_fwd", "layernorm_bwd"):
        return _ln_plan(operands["x2d"], name.endswith("_bwd"),
                        NOMINAL_SMS if slots is None else slots)
    raise KeyError(f"no launch plan for kernel {name!r}")


# --------------------------------------------------------------------------
# K001-K004 over a plan
# --------------------------------------------------------------------------
def _limits(profile):
    return DEVICE_PROFILES[profile] if isinstance(profile, str) else profile


def check_plan(name, launches, facts, *, rules=None, profile="h100",
               max_pages=None, label=""):
    """K001-K004 over one launch plan (:func:`launch_plan`)."""
    from ..ops.cuda import split_kv

    where = f"{label}/{name}" if label else name
    findings = []
    prof = _limits(profile)
    # K001: every output element has a block
    if _want(rules, "K001"):
        covered = {}
        for ln in launches:
            for buf, (shape, cover) in ln.writes.items():
                if buf in ln.partials or cover is None:
                    continue
                cover(covered.setdefault(buf, np.zeros(shape, np.int64)),
                      ln.grid)
        for buf, counts in covered.items():
            missing = int((counts == 0).sum())
            if missing:
                findings.append(Finding(
                    "K001", ERROR, where,
                    f"the grid leaves {missing} of {counts.size} elements "
                    f"of '{buf}' without a block — they are never written"))
    for ln in launches:
        at = f"{where}/{ln.kernel}"
        if _want(rules, "K002"):
            smem = ln.smem + (ln.static_smem or 0)
            if smem > prof["smem_per_block"]:
                findings.append(Finding(
                    "K002", ERROR, at,
                    f"{smem} B of shared memory a block (dynamic {ln.smem}"
                    f" + static {ln.static_smem or 0}) is over the card's "
                    f"{prof['smem_per_block']} B — the launch is refused"))
            if ln.threads > prof["threads_per_block"]:
                findings.append(Finding(
                    "K002", ERROR, at,
                    f"{ln.threads} threads a block, over "
                    f"{prof['threads_per_block']}"))
            if ln.regs is not None:
                if ln.regs > prof["regs_per_thread"]:
                    findings.append(Finding(
                        "K002", ERROR, at,
                        f"{ln.regs} registers a thread, over "
                        f"{prof['regs_per_thread']}"))
                if ln.regs * ln.threads > prof["regs_per_sm"]:
                    findings.append(Finding(
                        "K002", ERROR, at,
                        f"{ln.regs} registers x {ln.threads} threads = "
                        f"{ln.regs * ln.threads} is over an SM's "
                        f"{prof['regs_per_sm']}"))
            if ln.blocks_per_sm is not None and ln.blocks_per_sm < 1:
                findings.append(Finding(
                    "K002", ERROR, at,
                    "no block of this size is resident on an SM — the "
                    "launch cannot run"))
        if _want(rules, "K003"):
            x, y, z = ln.grid
            if x > GRID_X_MAX or y > GRID_YZ_MAX or z > GRID_YZ_MAX:
                findings.append(Finding(
                    "K003", ERROR, at,
                    f"grid {ln.grid} is past the card's limits "
                    f"({GRID_X_MAX}, {GRID_YZ_MAX}, {GRID_YZ_MAX})"))
        if _want(rules, "K004"):
            for buf, (shape, cover) in ln.writes.items():
                if cover is None:
                    continue
                counts = np.zeros(shape, np.int64)
                cover(counts, ln.grid)
                twice = int((counts > 1).sum())
                if twice:
                    findings.append(Finding(
                        "K004", ERROR, at,
                        f"{twice} elements of '{buf}' are written by more "
                        "than one block of the launch — the last writer "
                        "wins, in no fixed order"))
    if _want(rules, "K003"):
        splits = facts.get("splits")
        if splits is not None and splits * split_kv.CHUNK < facts["keys"]:
            findings.append(Finding(
                "K003", ERROR, where,
                f"{splits} splits of {split_kv.CHUNK} keys do not cover "
                f"the {facts['keys']} keys a row can hold"))
        if "slots" in facts:
            t, r, tile = facts["tokens"], facts["rows"], facts["tile"]
            slots = facts["slots"]
            nbytes = (slots * facts["num_q_heads"] * splits
                      * (facts["head_dim"] + 2) * 4)
            if slots < t and slots < r * tile:
                findings.append(Finding(
                    "K003", ERROR, where,
                    f"{slots} partial slots hold neither every token ({t})"
                    f" nor every row's last tile ({r} x {tile})"))
            elif slots >= t and t > r * tile and \
                    nbytes > split_kv.TOKEN_SCRATCH_BYTES:
                findings.append(Finding(
                    "K003", ERROR, where,
                    f"per-token partials take {nbytes} B, over "
                    f"TOKEN_SCRATCH_BYTES ({split_kv.TOKEN_SCRATCH_BYTES})"))
            if max_pages is not None and facts["pages"] < max_pages:
                findings.append(Finding(
                    "K003", ERROR, where,
                    f"block tables of {facts['pages']} pages cannot hold "
                    f"a sequence of max_pages={max_pages}"))
    return findings


# --------------------------------------------------------------------------
# the card's own numbers
# --------------------------------------------------------------------------
_INFO_INTS = 9
_INFO_KEYS = ("grid_x", "grid_y", "grid_z", "threads", "smem", "regs",
              "local_bytes", "static_smem", "blocks_per_sm")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def card_resources(name, launches, facts, **operands):
    """Call the source's C ``*_info`` entry for the launch of ``name`` at
    ``operands`` on the current CUDA device -> one dict a kernel
    (:data:`_INFO_KEYS`), in launch order; also stores the card's
    registers, spills, static shared bytes and blocks an SM on each
    :class:`Launch` of ``launches``.  Needs the card."""
    from ..ops.cuda import _build

    out = (ctypes.c_int * (1 + 4 * _INFO_INTS))()
    if name.startswith("paged_ragged_attention"):
        (t, nq, d), qdt = operands["q"]
        nkv = operands["k_pages"][0][2]
        fn = _build.load("ragged_attention").paged_ragged_attention_info
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
        rc = fn(int(name.endswith("_quant")), _DTYPE_CODE[qdt], t,
                facts["rows"], nq, nkv, d, facts["splits"], out)
    elif name == "decode_attention":
        (b, nq, d), qdt = operands["q"]
        nkv = operands["k_cache"][0][2]
        fn = _build.load("decode_attention").decode_attention_info
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        rc = fn(_DTYPE_CODE[qdt], b, nq, nkv, d, facts["splits"], out)
    elif name.startswith("flash_attention"):
        (b, sq, n, d), qdt = operands["q"]
        sk = operands["k"][0][1]
        fn = _build.load("flash_attention").flash_attention_info
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        rc = fn(int(name.endswith("_bwd")), _DTYPE_CODE[qdt], b, n, sq, sk, d,
                out)
    else:
        (rows, c), dt = operands["x2d"]
        fn = _build.load("layernorm").layernorm_info
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        rc = fn(int(name.endswith("_bwd")), _DTYPE_CODE[dt], rows, c,
                facts.get("nparts", 1), out)
    if rc != 0:
        raise RuntimeError(f"{name} info failed: CUDA error {rc}")
    records = []
    for i in range(out[0]):
        rec = dict(zip(_INFO_KEYS, out[1 + i * _INFO_INTS:
                                       1 + (i + 1) * _INFO_INTS]))
        records.append(rec)
        if i < len(launches):
            ln = launches[i]
            ln.regs, ln.local_bytes = rec["regs"], rec["local_bytes"]
            ln.static_smem = rec["static_smem"]
            ln.blocks_per_sm = rec["blocks_per_sm"]
    return records


# --------------------------------------------------------------------------
# K005 — registry contract
# --------------------------------------------------------------------------
def _loads_library(path):
    """Whether a module calls ``_build.load(...)``."""
    try:
        with open(path) as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return False
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "load" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "_build":
            return True
    return False


def _reaches_pallas_call(path, line):
    """Whether the ``def`` at ``path:line`` calls ``pallas_call``, itself
    or through functions of its module (transitively).  None when no
    ``def`` starts there."""
    with open(path) as f:
        tree = ast.parse(f.read())
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    start = [n for n in defs.values() if n.lineno == line or any(
        d.lineno == line for d in n.decorator_list)]
    if not start:
        return None
    seen, todo = set(), [start[0]]
    while todo:
        fn = todo.pop()
        if fn.name in seen:
            continue
        seen.add(fn.name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func.attr if isinstance(node.func, ast.Attribute) \
                else getattr(node.func, "id", "")
            if callee == "pallas_call":
                return True
            if callee in defs:
                todo.append(defs[callee])
    return False


def _smoke_parity_names(root):
    """Kernel names the keys of ``chip_smoke.py``'s PARITY_PHASES name."""
    path = os.path.join(root, "chip_smoke.py")
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "PARITY_PHASES"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            for key in node.value.keys:
                names.update(c.value for c in ast.walk(key)
                             if isinstance(c, ast.Constant)
                             and isinstance(c.value, str))
    return names


def check_registry(entries=None, search_dir=None, root=None):
    """K005: the registry contract over ``ops/cuda/`` (or
    ``search_dir``) and ``entries`` (default the registry's)."""
    from ..ops.cuda import registry

    root = root or _ROOT
    entries = registry.KERNELS if entries is None else entries
    search_dir = search_dir or os.path.dirname(
        os.path.abspath(registry.__file__))
    findings = []
    registered = {e.kernel.__module__.rsplit(".", 1)[-1]
                  for e in entries.values()}
    for fname in sorted(os.listdir(search_dir)):
        stem = fname[:-3]
        if fname.endswith(".py") and stem not in registered and \
                _loads_library(os.path.join(search_dir, fname)):
            findings.append(Finding(
                "K005", ERROR, f"kernels/{fname}",
                "module loads a CUDA library but registers no kernel — "
                "add an entry to ops/cuda/registry.py",
                category="unregistered"))
    smoke = _smoke_parity_names(root)
    for name in sorted(entries):
        e = entries[name]
        where = f"kernels/{name}"

        def bad(category, message):
            findings.append(Finding("K005", ERROR, where, message,
                                    category=category))

        if not callable(e.plain):
            bad("plain", f"plain version {e.plain!r} is not callable")
        parity = os.path.join(root, e.parity)
        if not os.path.exists(parity):
            bad("parity", f"parity test file {e.parity} does not exist")
        else:
            with open(parity) as f:
                src = f.read()
            names = (name, getattr(e.plain, "__name__", name),
                     getattr(e.kernel, "__name__", name))
            if "def test_" not in src or not any(n in src for n in names):
                bad("parity", f"{e.parity} defines no test naming "
                              f"{name!r}")
        if not os.path.exists(os.path.join(root, e.source)):
            bad("source", f"CUDA source {e.source} does not exist")
        path, _, line = e.replaces.partition(":")
        full = os.path.join(root, path)
        reaches = None
        if path.startswith("paddle_tpu/ops/pallas/") and \
                os.path.exists(full) and line.isdigit():
            reaches = _reaches_pallas_call(full, int(line))
        if not reaches:
            bad("replaces", f"replaces={e.replaces!r} is not a def under "
                            "paddle_tpu/ops/pallas/ that reaches "
                            "pallas_call")
        qual = f"paddle_tpu_torch::{name}"
        for key, what in (("CUDA", "CUDA implementation"),
                          ("CPU", "CPU implementation"),
                          ("Meta", "fake")):
            try:
                has = torch._C._dispatch_has_kernel_for_dispatch_key(qual,
                                                                     key)
            except RuntimeError:
                has = False
            if not has:
                bad("op", f"op {qual} has no {what}")
        if name not in smoke:
            bad("smoke", "chip_smoke.py's PARITY_PHASES has no phase for "
                         "it")
    return findings


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------
def main_path_calls():
    """(label, name, operands) of :data:`MAIN_PATH_SHAPES`."""
    for label, (name, ops) in MAIN_PATH_SHAPES.items():
        yield label, name, dict(ops)


def engine_calls(engine):
    """(label, name, operands) of every kernel node of the engine's
    bucket grid, traced (one per distinct shape)."""
    seen = set()
    for kind, bucket, body, operands in engine.executable_grid():
        for call in introspect_kernels(body, *operands):
            key = (call.name, tuple(sorted(
                (k, v) for k, v in call.operands.items()
                if isinstance(v, tuple))))
            if key in seen:
                continue
            seen.add(key)
            yield f"{kind}[{bucket}]", call.name, call.operands


def lint_registry(engine, rules=None, profile="h100", slots=None):
    """K005 over the registry, then K001-K004 over the launch plan of
    every kernel instance of ``engine``'s bucket grid (traced over fake
    tensors: nothing runs) and of :data:`MAIN_PATH_SHAPES`."""
    findings = []
    if _want(rules, "K005"):
        findings += check_registry()
    calls = list(engine_calls(engine)) + list(main_path_calls())
    for label, name, operands in calls:
        launches, facts = launch_plan(name, slots=slots, **operands)
        findings += check_plan(
            name, launches, facts, rules=rules, profile=profile,
            max_pages=(engine.max_pages if label.startswith(
                ("ragged", "draft")) else None),
            label=label)
    return findings
