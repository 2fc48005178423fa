"""The port's distributed checkpoint against the JAX package's (ROADMAP
A23b-6a): one on-disk format, loaded across the packages both ways.

- A JAX checkpoint written from the 8-device CPU mesh with ``P("x",
  None)`` (eight row blocks) loads in the port to the same values, in
  float32 and bfloat16 (the JAX block of ``ml_dtypes`` bfloat16 reads
  back as raw 2-byte items, which the port takes by their bits).
- A port checkpoint written by two ZeRO-3 ranks (one module-scoped pool,
  ``torch_dist_pool``) holds each rank's block only, at its global
  offsets, and loads in the JAX package's ``load_state_dict`` to the
  gathered weights, in float32 and bfloat16 (the port writes bfloat16
  as its exact float32 widening, which the JAX loader casts back; it
  cannot load its own bfloat16 blocks, a reference caveat pinned
  below), and in the port bitwise.
- Reshard on load: the two ranks' blocks load whole into one process's
  plain model.  A later save of a smaller world removes the stale rank
  files.  The v1 unversioned layout loads (the reference bodies run too,
  through ``test_torch_reference_bodies.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

import paddle_tpu_torch as P
import torch_dist_pool as TP
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu_torch.distributed import checkpoint as pck


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


def _w(seed=0, shape=(8, 6)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_mesh_checkpoint_loads_in_the_port(tmp_path, dtype):
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("x",))
    w = jnp.asarray(_w()).astype(dtype)
    sharded = jax.device_put(w, NamedSharding(mesh, Pspec("x", None)))
    path = str(tmp_path / "jax")
    jck.save_state_dict({"w": sharded, "b": np.ones(3, np.float32)}, path)
    with open(os.path.join(path, "meta_rank0.json")) as f:
        assert len(json.load(f)["w"]["shards"]) == 8
    out = pck.load_state_dict(path)
    want = torch.from_numpy(np.asarray(w.astype(jnp.float32)))
    assert out["w"].dtype == getattr(torch, dtype)
    assert torch.equal(out["w"].float(), want)
    np.testing.assert_array_equal(out["b"].numpy(), np.ones(3))


@pytest.fixture(scope="module")
def zero3(pool, tmp_path_factory):
    """Two ZeRO-3 ranks' checkpoints, f32 and bf16: dtype -> (path, the
    ranks' gathered weights and written offsets)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        path = str(tmp_path_factory.mktemp("zero3") / dtype)
        out[dtype] = (path, pool.run(TP.zero3_checkpoint_task, path, dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero3_ranks_write_only_their_blocks(zero3, dtype):
    _, outs = zero3[dtype]
    assert outs[0]["offsets"]["fc1.weight"] == [[0, 8], [0, 64]]
    assert outs[1]["offsets"]["fc1.weight"] == [[8, 16], [0, 64]]
    # fc2.weight [64, 16]: 32 rows a rank; the biases split too
    assert outs[1]["offsets"]["fc2.weight"] == [[32, 64], [0, 16]]
    assert outs[1]["offsets"]["fc2.bias"] == [[8, 16]]
    for k, w in outs[0]["weights"].items():
        np.testing.assert_array_equal(outs[1]["weights"][k], w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero3_checkpoint_loads_in_the_jax_package(zero3, dtype):
    path, outs = zero3[dtype]
    got = jck.load_state_dict(path)
    for k, w in outs[0]["weights"].items():
        assert str(got[k].dtype) == dtype
        np.testing.assert_array_equal(
            np.asarray(got[k].astype(jnp.float32)), w, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero3_checkpoint_loads_back_bitwise(zero3, dtype):
    path, outs = zero3[dtype]
    got = pck.load_state_dict(path)
    for k, w in outs[0]["weights"].items():
        assert got[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got[k].float().numpy(), w, err_msg=k)


def test_reshard_on_load_into_one_process(zero3):
    path, outs = zero3["float32"]
    model, _, _ = TP.sharded_model_and_data(seed=9)
    sd = model.state_dict()
    pck.load_state_dict(path, target_state_dict=sd)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), outs[0]["weights"][k])


def test_a_smaller_world_removes_stale_rank_files(pool, tmp_path):
    path = str(tmp_path / "ck")
    pool.run(TP.zero3_checkpoint_task, path, "float32")
    assert os.path.exists(os.path.join(path, "meta_rank1.json"))
    pck.save_state_dict({"w": torch.from_numpy(_w())}, path)
    assert sorted(os.listdir(path)) == ["data_rank0.npz", "meta_rank0.json"]
    with open(os.path.join(path, "meta_rank0.json")) as f:
        meta = json.load(f)
    assert meta["__world_size__"] == 1
    assert meta["__format_version__"] == pck.CHECKPOINT_FORMAT_VERSION == 2
    np.testing.assert_array_equal(pck.load_state_dict(path)["w"].numpy(),
                                  _w())


def test_v1_layout_and_missing_blocks(tmp_path):
    path = str(tmp_path / "old")
    os.makedirs(path)
    w = _w(1, (4, 2))
    np.savez(os.path.join(path, "data_rank0.npz"), shard_0=w[:2])
    with open(os.path.join(path, "meta_rank0.json"), "w") as f:
        json.dump({"w": {"shape": [4, 2], "dtype": "float32",
                         "shards": [{"offsets": [[0, 2], [0, 2]],
                                     "file": "shard_0"}]}}, f)
    with pytest.raises(ValueError, match="covers 4/8"):
        pck.load_state_dict(path)
    with pytest.raises(ValueError, match="covers 4/8"):
        jck.load_state_dict(path)
    pck._write_checkpoint(path, pck._host_items({"w": torch.from_numpy(
        w[2:])}), rank=1)
    with open(os.path.join(path, "meta_rank1.json")) as f:
        meta = json.load(f)
    meta["w"]["shape"] = [4, 2]
    meta["w"]["shards"][0]["offsets"] = [[2, 4], [0, 2]]
    del meta["__format_version__"]
    with open(os.path.join(path, "meta_rank1.json"), "w") as f:
        json.dump(meta, f)
    np.testing.assert_array_equal(pck.load_state_dict(path)["w"].numpy(), w)
    np.testing.assert_array_equal(np.asarray(jck.load_state_dict(path)["w"]),
                                  w)


def test_the_jax_package_cannot_load_its_own_bfloat16(tmp_path):
    """The reference caveat the port's bfloat16 blocks avoid."""
    path = str(tmp_path / "jbf16")
    jck.save_state_dict({"w": jnp.asarray(_w()).astype(jnp.bfloat16)}, path)
    with pytest.raises(ValueError, match="cast"):
        jck.load_state_dict(path)
    assert pck.load_state_dict(path)["w"].dtype == torch.bfloat16


def test_converter_and_async_save(tmp_path):
    w = torch.from_numpy(_w(2))
    out = pck.Converter().convert({"w": P.to_tensor(w.numpy())},
                                  target_shardings={"w": "cpu"})
    assert torch.equal(out["w"], w)
    path = str(tmp_path / "async")
    pck.async_save_state_dict({"w": w}, path)
    pck.wait_async_save()
    assert torch.equal(pck.load_state_dict(path)["w"], w)
