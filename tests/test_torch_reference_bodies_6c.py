"""The JAX package's bodies of the last module slice, run on the port.

The parameter server (``test_ps.py``, ``test_ps_service.py``,
``test_heter_cache.py``), fleet's dataset (``test_ps_dataset.py``), the
predictor's depth and the fused decoder (``test_rpc_elastic_inference.
py``'s classes past rpc and the relaunch), MoE (``test_moe.py``),
DeepFM (``test_models_asr_ctr.py::TestDeepFM``), the pipeline and the
hybrid trainer (``test_gpt_parallel.py``, ``test_models_zoo.py::
TestLlama::test_spmd_train_step_contract``) and the multi-process
bodies (``test_multihost.py``).  Each file's source is compiled as
``test_torch_reference_bodies.py`` compiles its files (imports of
``paddle_tpu`` made the port's) and each body runs once, on the CPU
(``paddle.set_device("cpu")``), over its parametrize grid, with the
module-level fixtures it asks for; a ``slow`` body keeps its mark.

A body that drives ``jax.jit``/``lax.scan``/``jax.grad`` over the
decomposition's functions, builds a jax Mesh, reads ``.sharding`` or a
jax array, or builds a model on the default device (the card in the
port) is listed in ``NOT_PORTED`` with the port test that holds its
fact.  ``test_spmd_trainer_spans_two_processes``' fact — the hybrid
trainer over two processes started by the launcher, both ranks seeing
the one global loss — runs below through the port's launcher.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu_torch as paddle
import test_torch_reference_bodies as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

SIXC = {
    "test_ps.py": None,
    "test_ps_dataset.py": None,
    "test_ps_service.py": None,
    "test_heter_cache.py": None,
    "test_rpc_elastic_inference.py": ("TestInferenceDepth",
                                      "TestFusedMultiTransformer"),
    "test_moe.py": None,
    "test_models_asr_ctr.py": ("TestDeepFM",),
    "test_gpt_parallel.py": None,
    "test_models_zoo.py": ("TestLlama::test_spmd_train_step_contract",),
    "test_multihost.py": None,
}
_CARD = ("builds {} on the default device, the card in the port; held "
         "with device='cpu' in ")
_JIT = ("runs the decomposition's functions under jax.jit/lax.scan/"
        "jax.grad, which cannot trace torch; held over gloo ranks in ")
_TP = "test_torch_parallel.py::"
_GP = "test_gpt_parallel.py::"
_TRAINER = (_CARD.format("gpt_tiny()") + _TP +
            "test_dp2_pp2_mp2_three_clipped_adamw_steps_match_jax")
NOT_PORTED = {
    _GP + "TestGPTModel::test_forward_shapes":
        _CARD.format("gpt_tiny()") + "test_torch_gpt.py",
    _GP + "TestGPTModel::test_loss_finite_and_backprops":
        _CARD.format("gpt_tiny()") + "test_torch_train.py",
    _GP + "TestGPTModel::test_decompose_matches_layer_forward":
        _JIT + _TP + "test_decompose_fns_match_the_jax_fns",
    _GP + "TestSpmdPipeline::test_pipeline_matches_sequential":
        _JIT + _TP + "test_spmd_pipeline_matches_jax",
    _GP + "TestSpmdPipeline::test_pipeline_grads_match_sequential":
        _JIT + _TP + "test_spmd_pipeline_matches_jax",
    _GP + "TestHybridTrainer::test_hybrid_2x2x2_runs_and_learns": _TRAINER,
    _GP + "TestHybridTrainer::test_hybrid_matches_single_device": _TRAINER,
    _GP + "TestHybridTrainer::test_pp_matches_no_pp": _TRAINER,
    **{_GP + "TestHybridTrainer::" + t:
       "reads the jax opt state's .sharding; held over eight gloo ranks "
       "in " + _TP + "test_zero_one_places_the_state_and_trains_as_jax"
       for t in ("test_zero_sharded_opt_state",
                 "test_zero_stage0_disables_opt_state_sharding",
                 "test_zero_over_dp_matches_dedicated_sharding_axis")},
    _GP + "TestGraftEntry::test_entry_and_dryrun":
        "runs the JAX package's __graft_entry__ (a jax program); the "
        "port's full-width run is chip_smoke.py's parallel phase, its "
        "CPU parity " + _TP + "test_dp2_pp2_mp2_three_clipped_adamw_"
        "steps_match_jax",
    _GP + "TestReviewRegressions::test_block_fn_restores_eval_mode":
        _CARD.format("gpt_tiny()") + _TP +
        "test_decompose_fns_match_the_jax_fns",
    _GP + "TestReviewRegressions::test_pipeline_dropout_varies_per_layer":
        _JIT + "test_torch_reference_bodies_6c.py::"
        "test_pipeline_dropout_varies_per_layer_and_repeats_per_key",
    _GP + "TestReviewRegressions::test_pipeline_layers_not_divisible_raises":
        _JIT + "test_torch_reference_bodies_6c.py::"
        "test_pipeline_layers_not_divisible_raises",
    **{_GP + "TestInterleavedPipeline::" + t:
       _JIT + _TP + "test_spmd_pipeline_matches_jax"
       for t in ("test_interleaved_matches_sequential",
                 "test_interleaved_grads_match_sequential")},
    _GP + "TestInterleavedPipeline::"
    "test_trainer_virtual_pp_matches_single_device":
        _CARD.format("gpt_tiny()") + _TP +
        "test_interleaved_remat_sequence_parallel_match_jax",
    _GP + "test_dryrun_multichip_16_devices_dedicated_sharding_axis":
        "runs the JAX package's __graft_entry__ on 16 virtual devices; "
        "the port's dedicated sharding axis is held in " + _TP +
        "test_zero_one_places_the_state_and_trains_as_jax",
    "test_models_zoo.py::TestLlama::test_spmd_train_step_contract":
        _CARD.format("llama_tiny()") + _TP +
        "test_llama_dp2_pp2_mp2_trains_with_zero_over_dp",
    "test_moe.py::test_moe_expert_parallel_sharded":
        "places the experts with jax.device_put over a jax Mesh; held over "
        "two gloo ranks in test_torch_moe.py::"
        "test_expert_parallel_over_two_ranks_equals_one_process",
    "test_ps_dataset.py::TestDevicePrefetch::"
    "test_prefetch_preserves_order_and_values":
        "asserts the prefetched batch is a jax.Array; the port's "
        "prefetch is held in test_torch_io.py",
    "test_ps_dataset.py::TestDevicePrefetch::test_prefetch_with_dataloader":
        "prefetches to the default device, the card in the port; the "
        "port's prefetch is held in test_torch_io.py",
    "test_heter_cache.py::TestRound5Hardening::"
    "test_pathological_duplicate_key_high_occupancy":
        "reads the compile cache of the JAX cache's jitted _adagrad_apply; "
        "the 64 rounds against the host table are held in "
        "test_torch_reference_bodies_6c.py::"
        "test_one_hot_key_64_times_matches_the_host_table",
    "test_ps_service.py::test_wide_deep_two_process_convergence":
        "its launched workers build WideDeep on the default device, the "
        "card in the port; the sharded service's rows are held by this "
        "file's test_ps_service.py bodies and test_torch_ps.py's "
        "test_ctr_model_logits_and_three_steps_match_jax",
    "test_rpc_elastic_inference.py::TestInferenceDepth::"
    "test_predictor_compiles_and_caches":
        "reads the JAX Predictor's _compiled_cache of jitted executables; "
        "the port's traced program a signature is held in "
        "test_torch_inference.py",
    "test_rpc_elastic_inference.py::TestInferenceDepth::"
    "test_mixed_precision_converts_params":
        "compares str(dtype) with 'bfloat16'; the port's is torch.bfloat16,"
        " held in test_torch_inference.py::"
        "test_mixed_precision_casts_once_and_follows_jax",
    "test_rpc_elastic_inference.py::TestInferenceDepth::"
    "test_dist_inference_shards_batch":
        "builds a jax Mesh over eight devices; held over two gloo ranks "
        "in test_torch_ps.py::"
        "test_enable_dist_inference_over_two_ranks_equals_one",
    "test_rpc_elastic_inference.py::TestFusedMultiTransformer::"
    "test_decode_matches_full_forward":
        _CARD.format("gpt_tiny()") + "test_torch_fused_multi_transformer.py",
    "test_rpc_elastic_inference.py::TestFusedMultiTransformer::"
    "test_sampled_generation_and_limits":
        _CARD.format("gpt_tiny()") + "test_torch_fused_multi_transformer.py",
    "test_multihost.py::test_two_process_bootstrap_and_collectives":
        "bootstraps jax.distributed and multihost_utils; the port's "
        "two-process bootstrap and collectives are held in "
        "test_torch_distributed.py and by the launch bodies of "
        "test_torch_reference_bodies.py",
    "test_multihost.py::test_spmd_trainer_spans_two_processes":
        "its worker runs the JAX trainer over a jax Mesh of two processes;"
        " the fact runs through the port's launcher in "
        "test_torch_reference_bodies_6c.py::"
        "test_spmd_trainer_spans_two_processes_through_the_launcher",
    "test_multihost.py::test_longcontext_bench_harness":
        "runs benchmarks/bench_longcontext.py, a JAX harness the port "
        "does not take over (no port benchmark yet); context parallelism "
        "is held in test_torch_sequence_parallel.py",
    "test_multihost.py::test_dcn_bandwidth_calibrates_across_processes":
        "calibrates over jax.distributed; held over two gloo ranks in "
        "test_torch_auto_parallel.py::test_calibrate_dcn_over_two_ranks",
}
BODIES = [b for b in R._bodies(tuple(SIXC))
          if R._selected(b, SIXC[b.split("::")[0]])]
RUN = [pytest.param(b, marks=pytest.mark.slow) if R._slow(b) else b
       for b in BODIES if b not in NOT_PORTED]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")


def test_the_bodies_are_collected_whole():
    """Every body of the selection is run or listed with the port test
    that holds its fact."""
    counts = {}
    for b in BODIES:
        counts[b.split("::")[0]] = counts.get(b.split("::")[0], 0) + 1
    assert counts == {"test_ps.py": 6, "test_ps_dataset.py": 9,
                      "test_ps_service.py": 24, "test_heter_cache.py": 19,
                      "test_rpc_elastic_inference.py": 7, "test_moe.py": 7,
                      "test_models_asr_ctr.py": 3,
                      "test_gpt_parallel.py": 20, "test_models_zoo.py": 1,
                      "test_multihost.py": 4}
    assert set(NOT_PORTED) <= set(BODIES)
    assert all("test_torch_" in why for why in NOT_PORTED.values())
    assert len(RUN) == len(BODIES) - len(NOT_PORTED)


@pytest.mark.parametrize("body", RUN)
def test_6c_reference_body(body, tmp_path, capsys):
    import contextlib
    import inspect

    fname, *names = body.split("::")
    mod = R._MODULES.get(fname) or R._MODULES.setdefault(fname,
                                                         R._load(fname))
    obj = getattr(mod, names[0])
    fn = getattr(obj(), names[1]) if len(names) == 2 else obj
    params = inspect.signature(fn).parameters
    for kwargs in R._grid(fn):
        with contextlib.ExitStack() as stack:
            kwargs.update(R._fixture_values(mod, fn, stack))
            kwargs.update((k, v) for k, v in (("tmp_path", tmp_path),
                                              ("capsys", capsys))
                          if k in params)
            if "monkeypatch" in params:
                kwargs["monkeypatch"] = stack.enter_context(
                    pytest.MonkeyPatch.context())
            paddle.seed(0)
            np.random.seed(0)
            fn(**kwargs)


# ----------------------------- the listed bodies' facts, in torch --
def _tiny(**kw):
    from paddle_tpu_torch.models.gpt import gpt_tiny

    return gpt_tiny(device="cpu", **kw)


def test_pipeline_dropout_varies_per_layer_and_repeats_per_key():
    """``_layer_scan`` with dropout on: one key gives the same output
    twice, another key a different one (the masks are drawn per layer
    from the key)."""
    import torch

    from paddle_tpu_torch.parallel.pipeline import _layer_scan

    model = _tiny(num_layers=2, hidden_dropout_prob=0.5)
    model.train()
    d = model.functional_decompose()
    block_fn = d["fns"][1]
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 64)
                         .astype(np.float32))
    o1 = _layer_scan(block_fn, x, d["params"]["blocks"], 0)
    o1b = _layer_scan(block_fn, x, d["params"]["blocks"], 0)
    o2 = _layer_scan(block_fn, x, d["params"]["blocks"], 1)
    assert torch.equal(o1, o1b)
    assert not torch.equal(o1, o2)
    # and the two layers draw different masks: the same key per layer
    # (each layer reseeded alike) gives another output
    same = block_fn.generators

    def fixed(p, h):
        for g, _ in same:
            g.manual_seed(0)
        return block_fn(p, h)

    fixed.generators = []
    o_same = _layer_scan(fixed, x, d["params"]["blocks"], 0)
    assert not torch.equal(o1, o_same)


def test_pipeline_layers_not_divisible_raises():
    from paddle_tpu_torch.parallel import spmd_pipeline

    class Mesh:
        axis_names = ("pp",)

        def axis_size(self, axis):
            return 4

    import torch

    model = _tiny(num_layers=6)
    d = model.functional_decompose()
    with pytest.raises(AssertionError, match="not divisible by pp"):
        spmd_pipeline(d["fns"][1], d["params"]["blocks"],
                      torch.ones(8, 16, 64), mesh=Mesh(), n_microbatches=2)


def test_one_hot_key_64_times_matches_the_host_table():
    """One hot key 64 times in one push (64 Adagrad rounds) and three cold
    ones through the cache equal the host table's sequential pushes."""
    from paddle_tpu_torch.distributed.ps import HotRowCache, SparseTable

    lr = 0.1
    remote, baseline = (SparseTable(dim=4, optimizer="adagrad",
                                    learning_rate=lr, init_range=0.01,
                                    seed=23) for _ in range(2))
    cache = HotRowCache(remote, optimizer="adagrad", learning_rate=lr,
                        capacity=8, device="cpu")
    keys = np.concatenate([np.full(64, 5, np.int64),
                           np.arange(3, dtype=np.int64)])
    g = np.random.RandomState(0).randn(len(keys), 4).astype(np.float32)
    cache.pull(keys)
    cache.push(keys, g)
    cache.flush()
    baseline.pull(keys)
    baseline.push(keys, g, learning_rate=lr)
    np.testing.assert_allclose(remote.pull(keys), baseline.pull(keys),
                               rtol=2e-5, atol=2e-6)


TRAINER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist, optimizer
    from paddle_tpu_torch.distributed.fleet import build_mesh
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.parallel import SpmdTrainStep

    dist.init_parallel_env(device="cpu", timeout=60)
    rank = dist.get_rank()
    model = gpt_tiny(device="cpu", num_layers=2, seed=3)
    opt = optimizer.AdamW(learning_rate=1e-2,
                          parameters=model.parameters())
    tr = SpmdTrainStep(model, opt, build_mesh(pp=2), n_microbatches=2)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (4, 16))
    losses = [float(tr.step(ids, ids)) for _ in range(3)]
    print("RANK", rank, "TRAINER", *losses, flush=True)
    dist.destroy_process_group()
""")


def test_spmd_trainer_spans_two_processes_through_the_launcher(tmp_path):
    """The hybrid trainer over a pp = 2 mesh of two processes that the
    port's launcher starts: both ranks see the identical global loss,
    and it falls."""
    script = tmp_path / "trainer.py"
    script.write_text(TRAINER.format(repo=REPO))
    log_dir = str(tmp_path / "logs")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", log_dir, str(script)],
        cwd=REPO, capture_output=True, timeout=120, env=env)
    assert rc.returncode == 0, rc.stderr.decode()[-2000:]
    losses = {}
    for r in range(2):
        with open(os.path.join(log_dir, f"workerlog.{r}")) as f:
            line = [ln for ln in f.read().splitlines()
                    if ln.startswith(f"RANK {r} TRAINER")][0]
        losses[r] = tuple(float(x) for x in line.split()[3:])
    assert losses[0] == losses[1], losses
    assert losses[0][-1] < losses[0][0]
