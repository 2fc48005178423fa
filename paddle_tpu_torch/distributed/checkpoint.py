"""Distributed checkpoint: sharded save/load with reshard-on-load.

Port of ``paddle_tpu/distributed/checkpoint.py`` (reference
DistributedSaver, auto_parallel/static/dist_saver.py, and Converter,
auto_parallel/static/converter.py).  The on-disk format is the JAX
package's, so either package loads the other's checkpoints:
``<path>/meta_rank{r}.json`` describes every tensor (shape, dtype, and
its blocks with their global offsets) and ``<path>/data_rank{r}.npz``
holds the blocks; ``__format_version__`` is
:data:`CHECKPOINT_FORMAT_VERSION` (2), an unstamped checkpoint is v1 and
loads through the registered upgrader, and rank 0 of a save removes the
files of ranks beyond the world.

The JAX package is one controller: a process writes the shards it
addresses of each global array.  The port runs one process a rank, and a
rank writes each tensor whole, with offsets 0, except a tensor of a
ZeRO-3 model's state dict (``sharding.ShardedStateDict.shards``): only
the block this rank holds, at its global offsets.  Loading merges every
rank's blocks into the whole tensor and places it like the target
(its device and dtype; a ZeRO-3 model then keeps its block through
``set_state_dict``).

bfloat16: the JAX package writes a block through ``ml_dtypes``, and
``np.load`` reads it back as ``|V2`` (raw 2-byte payloads; the card's
machine has no ``ml_dtypes`` at all).  The port reads a ``"bfloat16"``
block of 2-byte items from its bits (``.view(torch.bfloat16)``).  It
writes a bfloat16 tensor with meta dtype ``"bfloat16"`` and its float32
widening as the block (exact: every bfloat16 is a float32): the JAX
loader fills ``np.empty(shape, "bfloat16")`` from the block by a value
cast, which float32 takes exactly and a 2-byte payload does not (a
``uint16`` view would be cast as integers, a ``|V2`` one refused — the
JAX package cannot load its own bfloat16 checkpoints, a reference
caveat).  The port reads a float32 block of a ``"bfloat16"`` entry back
exactly.
"""

import glob
import json
import os
import re
import threading

import numpy as np
import torch

from ..core.tensor import Tensor


def _np(t):
    """(host array, meta dtype) of a torch tensor; bfloat16 as its
    float32 widening (module docstring)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _to_host_shards(val, shard=None):
    """(list of (global index ranges, host block), global shape, dtype)
    of one value: whole, or the block ``shard`` = (axis, index, count)
    names."""
    if isinstance(val, Tensor):
        val = val._data
    if not isinstance(val, torch.Tensor):
        a = np.asarray(val)
        return [(tuple((0, s) for s in a.shape), a)], a.shape, str(a.dtype)
    shape = tuple(val.shape)
    idx = [(0, s) for s in shape]
    if shard is not None:
        axis, i, n = shard
        k = shape[axis] // n
        val = val.narrow(axis, i * k, k)
        idx[axis] = (i * k, (i + 1) * k)
    a, dtype = _np(val)
    return [(tuple(idx), a)], shape, dtype


# On-disk format version (reference op_version_registry.h +
# program_converter.cc role: old artifacts keep loading after the format
# evolves).  v1 = round-2 files with no version stamp; v2 adds the stamp.
# Bump this when the layout changes and register an upgrader for the old
# version — load runs the chain oldest->current.
CHECKPOINT_FORMAT_VERSION = 2

_UPGRADERS = {}


def register_checkpoint_upgrader(from_version):
    """Decorator: ``fn(merged) -> merged`` migrating ``from_version`` to
    ``from_version + 1`` (merged = key -> {shape, dtype, entries})."""

    def deco(fn):
        _UPGRADERS[int(from_version)] = fn
        return fn

    return deco


@register_checkpoint_upgrader(1)
def _upgrade_v1_to_v2(merged):
    # v1 (round 2) has the identical shard layout, only the stamp is new
    return merged


def _serialize_shards(host_items):
    """host_items: dict key -> (shards, shape, dtype).  Returns (meta, blobs)
    — the single definition of the on-disk format."""
    meta = {}
    blobs = {}
    counter = 0
    for key, (shards, shape, dtype) in host_items.items():
        entries = []
        for idx, data in shards:
            fname = f"shard_{counter}"
            counter += 1
            blobs[fname] = data
            entries.append({"offsets": [list(p) for p in idx],
                            "file": fname})
        meta[key] = {"shape": list(shape), "dtype": dtype,
                     "shards": entries}
    return meta, blobs


def _rank_world():
    from .parallel import get_rank, get_world_size
    return get_rank(), get_world_size()


def _write_checkpoint(path, host_items, rank=None):
    """Write this rank's blocks as per-rank files.

    An explicit ``rank=`` means the caller lays out a multi-rank
    checkpoint from one process (tests, offline reshard tools): then the
    world size is neither stamped nor used to delete sibling files."""
    explicit_rank = rank is not None
    world = None
    if rank is None:
        rank, world = _rank_world()
    os.makedirs(path, exist_ok=True)
    if not explicit_rank and rank == 0:
        # Remove stale files from ranks that no longer exist (a previous
        # save with a larger world size); merging them at load would
        # silently resurrect old parameter values.
        for mf in glob.glob(os.path.join(path, "meta_rank*.json")):
            m = re.match(r"meta_rank(\d+)\.json$", os.path.basename(mf))
            if m and int(m.group(1)) >= world:
                os.remove(mf)
                stale = os.path.join(path, f"data_rank{m.group(1)}.npz")
                if os.path.exists(stale):
                    os.remove(stale)
        for legacy in ("meta.json", "data.npz"):
            lf = os.path.join(path, legacy)
            if os.path.exists(lf):
                os.remove(lf)
    meta, blobs = _serialize_shards(host_items)
    meta["__format_version__"] = CHECKPOINT_FORMAT_VERSION
    if not explicit_rank:
        meta["__world_size__"] = world
    np.savez(os.path.join(path, f"data_rank{rank}.npz"), **blobs)
    with open(os.path.join(path, f"meta_rank{rank}.json"), "w") as f:
        json.dump(meta, f)


def _host_items(state_dict):
    shards = getattr(state_dict, "shards", {})
    return {key: _to_host_shards(val, shards.get(key))
            for key, val in state_dict.items()}


def save_state_dict(state_dict, path, process_group=None, coordinator=None):
    """Save a state dict as this rank's blocks + metadata (module
    docstring)."""
    _write_checkpoint(path, _host_items(state_dict))


def _read_all_ranks(path):
    """Merge every rank's metadata into key -> (shape, dtype, entries) with
    per-entry blob lookups; accepts the legacy single-file layout too."""
    metas = []
    for mf in sorted(glob.glob(os.path.join(path, "meta_rank*.json"))):
        rank_tag = os.path.basename(mf)[len("meta_rank"):-len(".json")]
        with open(mf) as f:
            metas.append((json.load(f),
                          np.load(os.path.join(path,
                                               f"data_rank{rank_tag}.npz"))))
    legacy = os.path.join(path, "meta.json")
    if not metas and os.path.exists(legacy):
        with open(legacy) as f:
            metas.append((json.load(f),
                          np.load(os.path.join(path, "data.npz"))))
    if not metas:
        raise FileNotFoundError(f"no checkpoint metadata under {path}")
    worlds = {m.get("__world_size__") for m, _ in metas}
    declared = next((w for w in worlds if w is not None), None)
    if len(worlds) > 1 or (declared is not None and declared != len(metas)):
        raise ValueError(
            f"inconsistent checkpoint under {path}: found {len(metas)} rank "
            f"files but metadata declares world size(s) {sorted(worlds, key=str)} "
            "— files from different save epochs are mixed")
    versions = {m.get("__format_version__", 1) for m, _ in metas}
    if len(versions) > 1:
        raise ValueError(
            f"inconsistent checkpoint under {path}: rank files carry mixed "
            f"format versions {sorted(versions)}")
    version = versions.pop()
    if version > CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"checkpoint under {path} has format v{version}, newer than "
            f"this build's v{CHECKPOINT_FORMAT_VERSION} — upgrade "
            "paddle_tpu_torch to load it")
    merged = {}
    for meta, blobs in metas:
        for key, desc in meta.items():
            if key in ("__world_size__", "__format_version__"):
                continue
            slot = merged.setdefault(
                key, {"shape": desc["shape"], "dtype": desc["dtype"],
                      "entries": {}})
            for entry in desc["shards"]:
                idx = tuple(tuple(p) for p in entry["offsets"])
                if idx not in slot["entries"]:  # replicated across ranks
                    slot["entries"][idx] = blobs[entry["file"]]
    while version < CHECKPOINT_FORMAT_VERSION:
        upgrader = _UPGRADERS.get(version)
        if upgrader is None:
            raise ValueError(
                f"no upgrade path from checkpoint format v{version}")
        merged = upgrader(merged)
        version += 1
    return merged


def _block_tensor(data, dtype):
    """A stored block as a torch tensor; a ``"bfloat16"`` block from its
    bits when its items have 2 bytes (the JAX package's, read back as
    |V2), else by an exact cast (the port's float32 widening)."""
    data = np.ascontiguousarray(data)
    if dtype == "bfloat16":
        if data.dtype.itemsize == 2:
            return torch.from_numpy(data.view(np.int16)).view(
                torch.bfloat16)
        return torch.from_numpy(data).to(torch.bfloat16)
    return torch.from_numpy(data)


def _whole(key, desc, path):
    """The whole tensor of one merged entry, from its blocks."""
    dtype = desc["dtype"]
    tdt = torch.bfloat16 if dtype == "bfloat16" else \
        torch.from_numpy(np.empty(0, dtype=dtype)).dtype
    full = torch.empty(desc["shape"], dtype=tdt)
    covered = 0
    for idx, data in desc["entries"].items():
        sl = tuple(slice(a, b) for a, b in idx)
        full[sl] = _block_tensor(data, dtype).reshape(
            [b - a for a, b in idx])
        covered += int(np.prod([b - a for a, b in idx]))
    total = int(np.prod(desc["shape"])) if desc["shape"] else 1
    if covered < total:
        raise ValueError(
            f"checkpoint for '{key}' covers {covered}/{total} elements "
            f"— a rank's shard files are missing from {path}")
    return full


def load_state_dict(path, target_state_dict=None, shardings=None):
    """Load a checkpoint: every tensor whole, placed like the target.

    - target_state_dict: dict name -> Tensor / torch tensor whose device
      and dtype the loaded tensor takes.  Updated in place (a Tensor
      takes the value, a torch tensor is copied into), and also returned.
    - shardings: optional dict name -> ``torch.device`` (or a device
      string) overriding the target's device.
    """
    merged = _read_all_ranks(path)
    out = {}
    for key, desc in merged.items():
        full = _whole(key, desc, path)
        cur = None if target_state_dict is None else \
            target_state_dict.get(key)
        like = cur._data if isinstance(cur, Tensor) else cur
        if isinstance(like, torch.Tensor):
            full = full.to(device=like.device, dtype=like.dtype)
        if shardings and key in shardings:
            full = full.to(shardings[key])
        if isinstance(cur, Tensor):
            cur.set_value(full)
        elif isinstance(cur, torch.Tensor):
            with torch.no_grad():
                cur.copy_(full)
        out[key] = full
    return out


class Converter:
    """Reshard a checkpoint across parallel configs (reference
    static/converter.py).  With the shard-metadata format, conversion is
    reassembly + re-placement, so this class is a thin veneer kept for
    API parity: each value whole, on its target device when given."""

    def __init__(self, strategy=None, pre_strategy=None):
        self._strategy = strategy
        self._pre_strategy = pre_strategy

    def convert(self, state_dict, target_shardings=None):
        out = {}
        for k, v in state_dict.items():
            data = v._data if isinstance(v, Tensor) else v
            full = data.detach().clone() if isinstance(data, torch.Tensor) \
                else torch.as_tensor(np.asarray(data))
            if target_shardings and k in target_shardings:
                full = full.to(target_shardings[k])
            out[k] = full
        return out


class _AsyncSaver:
    def __init__(self):
        self._thread = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, state_dict, path):
        self.wait()
        # snapshot to host synchronously so training can mutate params
        host = _host_items(state_dict)
        self._thread = threading.Thread(
            target=_write_checkpoint, args=(path, host), daemon=True)
        self._thread.start()


_async_saver = _AsyncSaver()


def async_save_state_dict(state_dict, path):
    """Kick off a background save; ``wait_async_save()`` joins it."""
    _async_saver.save(state_dict, path)


def wait_async_save():
    _async_saver.wait()
