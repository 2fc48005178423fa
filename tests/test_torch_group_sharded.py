"""The port's ZeRO stages against plain training (ROADMAP A23b-6a).

The reference's own contract (``tests/test_group_sharded.py``): a model
under ``group_sharded_parallel`` at ``os``, ``os_g`` or ``p_g_os`` trains
to the plain model's losses (its ``_model_and_data``, ``_train`` and
AdamW, within 1e-5).  Here the group is two gloo ranks (one
module-scoped pool, ``torch_dist_pool``), each training on the same
batch: both ranks' losses, whole weights and gathered optimizer state
equal the plain run's, also under the global-norm, per-tensor and value
clips (which the sliced steps compute over the group).  A ``p_g_os``
parameter holds only its block at rest (its storage freed, a block of
half its rows kept), and the optimizer state of every level is a block.
The reference bodies themselves run at world size 1 through
``test_torch_reference_bodies.py``.
"""

import os

import numpy as np
import pytest

import paddle_tpu_torch as P
import torch_dist_pool as TP
from paddle_tpu_torch.distributed.sharding import (_shard_spec,
                                                   group_sharded_parallel)

LEVELS = ["os", "os_g", "p_g_os"]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


@pytest.mark.parametrize("clip", [None, "global", "norm", "value"])
@pytest.mark.parametrize("level", LEVELS)
def test_level_trains_to_the_plain_losses(pool, level, clip):
    losses, weights, opt = TP.plain_sharded_reference(clip)
    outs = pool.run(TP.group_sharded_task, level, clip)
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        for k, w in weights.items():
            np.testing.assert_allclose(out["weights"][k], w, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert out["opt"].keys() == opt.keys()
        for k, v in opt.items():
            np.testing.assert_allclose(out["opt"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("level", LEVELS)
def test_what_a_rank_holds_at_rest(pool, level):
    outs = pool.run(TP.group_sharded_task, level)
    for out in outs:
        rest = out["rest"]
        # fc1.weight [16, 64] is sliced along dim 0: 8 rows a rank
        assert rest["moment1"] == (8, 64)
        if level == "p_g_os":
            assert rest["storage"] == 0 and rest["block"] == (8, 64)
        else:
            assert rest["storage"] == 16 * 64 * 4


def test_shard_spec_is_the_jax_dim():
    from paddle_tpu.distributed.sharding import _shard_spec as jspec

    for shape in [(16, 64), (3, 8), (5, 7), (1,), (8,), (6, 4, 2), ()]:
        for n in (2, 4, 8):
            spec = tuple(jspec(shape, n))
            want = spec.index("sharding") if "sharding" in spec else None
            assert _shard_spec(shape, n) == want, (shape, n)


def test_save_group_sharded_model_writes_the_whole_state(pool, tmp_path):
    from paddle_tpu.framework_io import load as jload
    from paddle_tpu_torch.framework_io import load

    out = str(tmp_path / "ckpt")
    weights = pool.run(TP.save_sharded_task, out, "p_g_os")
    for sd in (load(os.path.join(out, "model.pdmodel")),
               jload(os.path.join(out, "model.pdmodel"))):
        assert sd["fc1.weight"].shape == (16, 64)
        for k, w in weights[0].items():
            np.testing.assert_array_equal(np.asarray(sd[k]), w)
    opt = load(os.path.join(out, "model.pdopt"))
    assert opt["param0.moment1"].shape == (16, 64)


def test_bad_level_raises_and_one_rank_is_plain():
    model, x, y = TP.sharded_model_and_data()
    from paddle_tpu_torch import optimizer

    opt = optimizer.AdamW(parameters=model.parameters())
    with pytest.raises(ValueError, match="level"):
        group_sharded_parallel(model, opt, level="bogus")
    losses, weights, _ = TP.plain_sharded_reference()
    model, x, y = TP.sharded_model_and_data()
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters())
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    np.testing.assert_array_equal(TP.sharded_train(model, opt, x, y),
                                  losses)
