"""The bodies of the JAX package's op-surface tests, run on the port.

Each reference file's source is compiled with its imports of
``paddle_tpu`` turned into imports of ``paddle_tpu_torch`` and nothing
else changed; every test function and test method runs once, on the
CPU (none of these files parametrises), with ``paddle.seed(0)`` and
numpy's global generator seeded, so that a body's unseeded draws are
the same in every run whatever ran before it in the worker.  The dispatch-cache bodies that
assert compiled counts, cache entries, the untraceable-op ban or a
speedup from compiling cannot hold where eager torch compiles nothing
(the port's cache reports an empty cache by design); they are listed in
``NOT_PORTED`` with the reason, and ROADMAP "Not ported by design"
names them.

The deployment slice's bodies (``DEPLOY``: quantization, dy2static,
``to_static``, ``jit.save``/``load``, the predictor, its server and the
C client) run by file, class or function name; a body that needs a
module-level pytest fixture gets it, set up and torn down around the
body.

The speech path's, the zoo's, datasets' and ``text``'s slice of three
more files (``SLICE``) runs by class and function name: the
``test_api_longtail.py`` bodies in the default tier, the
``test_models_zoo.py`` and ``test_models_asr_ctr.py`` ones under the
``slow`` mark their files carry.  ``SLICE_NOT_PORTED`` names the bodies
that wait for later parts of the port, ``ELSEWHERE`` the ones that
drive earlier slices' models, held by those slices' own tests.

The program tooling's bodies (``PROGRAM``: the ProgramDesc exporter and
importer, custom ops, the ``program`` lint) run by file or name, each
keeping the ``slow`` mark its reference test carries; a body that
drives ``jax.numpy`` on a Tensor's data or reads the JAX registry's
``jax_fn`` is listed in ``PROGRAM_NOT_PORTED`` with the port test that
holds its torch spelling.
"""

import inspect
import os
import re
import sys
import types

import numpy as np
import pytest

import paddle_tpu_torch as paddle

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ("test_ops_extended.py", "test_tensor_ops.py", "test_nn.py",
         "test_optimizer.py", "test_dispatch_cache.py",
         "test_incubate_functional.py")

_COMPILES = "asserts what the jit dispatch cache compiled; nothing compiles"
_DTYPE = ("compares Tensor.dtype with a numpy dtype; the port's is a "
          "torch.dtype, held in test_dtype_bodies_in_torch_dtypes")
_DC = "test_dispatch_cache.py::TestDispatchCache::"
NOT_PORTED = {
    _DC + "test_cached_matches_uncached_forward": _COMPILES,
    _DC + "test_cached_grad_matches_uncached": _COMPILES,
    _DC + "test_distinct_shapes_get_distinct_entries": _COMPILES,
    _DC + "test_untraceable_op_banned_across_shapes":
        "reads the ban set of untraceable ops; nothing is traced",
    _DC + "test_steady_state_speedup":
        "times the compiled path against the uncached one; nothing compiles",
    "test_tensor_ops.py::TestCreation::test_zeros_ones_full": _DTYPE,
    "test_tensor_ops.py::TestDtype::test_astype": _DTYPE,
    "test_tensor_ops.py::TestDtype::test_default_dtype": _DTYPE,
}


# The speech path, the vision zoo, datasets and text (the slice of
# test_api_longtail.py, test_models_zoo.py and test_models_asr_ctr.py
# whose modules the port holds): bodies run by class or function name.
# The zoo and ASR bodies carry their files' ``slow`` mark.
SLICE = {
    "test_api_longtail.py": (("TestVisionDatasets", "TestAudio",
                              "TestViterbi", "TestOnnxExport",
                              "TestCostModel"), False),
    "test_models_zoo.py": (("test_vgg_forward_backward",
                            "test_mobilenetv2_forward",
                            "test_rnn_layers_forward_shapes",
                            "test_lstm_gradient_flows",
                            "test_deepspeech2_ctc_trains",
                            "TestRound4VisionZoo"), True),
    "test_models_asr_ctr.py": (("TestConformer",), True),
}
_JNP = ("calls jax.numpy on the Tensor's data, which is a torch tensor in "
        "the port; held with the torch spelling in ")
SLICE_NOT_PORTED = {
    "test_api_longtail.py::TestOnnxExport::"
    "test_unsupported_primitive_raises_loudly":
        _JNP + "test_torch_onnx.py",
}
# bodies of those files that drive models of other slices, held there
# by their own parity tests (the parameter server's and the hybrid
# trainer's run in test_torch_reference_bodies_6c.py) and not part of
# this slice's reference set
ELSEWHERE = {
    **{f"test_models_asr_ctr.py::TestDeepFM::{t}":
       "test_torch_reference_bodies_6c.py" for t in (
           "test_fm_math_matches_manual", "test_converges_on_ctr_task",
           "test_over_sharded_ps_service")},
    "test_models_zoo.py::TestLlama::test_spmd_train_step_contract":
        "test_torch_reference_bodies_6c.py",
    "test_models_zoo.py::test_vit_trains": "test_torch_vision.py",
    "test_models_zoo.py::test_bert_classification_trains":
        "test_torch_bert.py",
    "test_models_zoo.py::test_bert_pretraining_loss": "test_torch_bert.py",
    **{f"test_models_zoo.py::TestLlama::{t}": "test_torch_llama.py"
       for t in ("test_forward_backward_and_learns",
                 "test_gqa_heads_and_rope_shapes",
                 "test_decode_matches_dense_forward",
                 "test_decode_past_cache_raises")},
}


# This slice's bodies (ROADMAP A23b-3b and A23b-4 but quantization): whole
# files (None) or the classes and methods the slice ports.  A
# parametrised body runs once, over its whole grid.
FEATURES = {
    "test_namespaces_transforms.py": None,
    "test_sparse_depth.py": None,
    "test_autograd.py": None,
    "test_incubate_extras.py": ("TestLookAhead", "TestModelAverage",
                                "TestASP"),
    "test_profiler.py": None,
    "test_api_surfaces.py": None,
    "test_jit.py": ("TestCompiledGradScaler",),
    "test_io.py": ("TestAmp::test_grad_scaler_fp16_flow",),
}
FEATURES_NOT_PORTED = {
    "test_namespaces_transforms.py::TestTransforms::"
    "test_exp_sigmoid_tanh_jacobians_match_autodiff":
        "differentiates the transforms with jax.vmap(jax.grad); held with "
        "torch.func in test_torch_namespaces.py",
    "test_autograd.py::TestCreateGraph::"
    "test_backward_create_graph_populates_differentiable_grad":
        "reads the JAX tape's GradNode (_node); the port's grad carries "
        "torch's grad_fn, held in test_torch_incubate.py",
    "test_api_surfaces.py::test_stft_istft_round_trip":
        "passes a jax array as the window; held with a torch window in "
        "test_torch_namespaces.py",
}


def _port_source(path):
    """The file's source with its imports of ``paddle_tpu`` (the lines of
    the scripts a body writes too) made imports of ``paddle_tpu_torch``,
    and the launcher's module name, which the launch bodies pass to
    ``python -m`` as a string, made the port's."""
    src = open(path).read()
    src = re.sub(r"^(\s*(?:import|from)\s+)paddle_tpu\b(?!_torch)",
                 r"\1paddle_tpu_torch", src, flags=re.M)
    return re.sub(r"""(["'])paddle_tpu\.distributed\.launch\1""",
                  r"\1paddle_tpu_torch.distributed.launch\1", src)


def _load(name):
    mod = types.ModuleType(f"_port_{name[:-3]}")
    mod.__file__ = os.path.join(HERE, name)
    # registered, so that pickle finds the classes a body defines
    sys.modules[mod.__name__] = mod
    exec(compile(_port_source(mod.__file__), mod.__file__, "exec"),
         mod.__dict__)
    return mod


def _bodies(files=FILES):
    out = []
    for name in files:
        path = os.path.join(HERE, name)
        src = open(path).read()
        for m in re.finditer(r"^(class (Test\w+)|def (test_\w+))", src,
                             re.M):
            if m.group(3):
                out.append(f"{name}::{m.group(3)}")
                continue
            body = src[src.index("\n", m.end()) + 1:]
            nxt = re.search(r"^\S", body, re.M)
            block = body[:nxt.start()] if nxt else body
            out += [f"{name}::{m.group(2)}::{t}" for t in
                    re.findall(r"^    def (test_\w+)", block, re.M)]
    return out


BODIES = _bodies()
RUN = [b for b in BODIES if b not in NOT_PORTED]
SLICE_BODIES = _bodies(tuple(SLICE))
SLICE_RUN = [pytest.param(b, marks=pytest.mark.slow) if SLICE[
    b.split("::")[0]][1] else b for b in SLICE_BODIES
    if b.split("::")[1] in SLICE[b.split("::")[0]][0]
    and b not in SLICE_NOT_PORTED]
_MODULES = {}


def _selected(body, names):
    """Whether ``body`` (file::[Class::]name) is among ``names`` (class
    names or Class::method), or ``names`` is None (the whole file)."""
    rest = body.split("::", 1)[1]
    return names is None or any(rest == n or rest.startswith(n + "::")
                                for n in names)


FEATURE_BODIES = [b for b in _bodies(tuple(FEATURES))
                  if _selected(b, FEATURES[b.split("::")[0]])]
FEATURE_RUN = [b for b in FEATURE_BODIES if b not in FEATURES_NOT_PORTED]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")


def test_the_bodies_are_collected_whole():
    """Every reference test of the six files is run or listed."""
    counts = {}
    for b in BODIES:
        counts[b.split("::")[0]] = counts.get(b.split("::")[0], 0) + 1
    assert counts == {"test_ops_extended.py": 48, "test_tensor_ops.py": 26,
                      "test_nn.py": 33, "test_optimizer.py": 14,
                      "test_dispatch_cache.py": 11,
                      "test_incubate_functional.py": 10}
    assert set(NOT_PORTED) <= set(BODIES)


def test_dtype_bodies_in_torch_dtypes():
    """The three dtype bodies of test_tensor_ops.py, with the port's
    torch dtypes in place of numpy's."""
    import torch

    assert paddle.zeros([2, 3]).shape == [2, 3]
    assert paddle.ones([2], dtype="int32").dtype == torch.int32
    np.testing.assert_allclose(paddle.full([2, 2], 3.5).numpy(), 3.5)
    x = paddle.to_tensor(np.ones((2, 2)))
    assert x.astype("int32").dtype == torch.int32
    assert x.astype(paddle.bfloat16).dtype == torch.bfloat16
    assert paddle.get_default_dtype() == torch.float32
    assert paddle.to_tensor([1.5]).dtype == torch.float32


def test_dispatch_cache_api_reports_an_empty_cache():
    """The JAX cache's switches keep their signatures; the port's cache
    is empty whatever runs, and the debug hook sees each op's outputs."""
    from paddle_tpu_torch.ops import (dispatch_cache_clear,
                                      dispatch_cache_info,
                                      enable_dispatch_cache, set_debug_hook)

    enable_dispatch_cache(True)
    x = paddle.to_tensor(np.ones((2, 2), np.float32))
    for _ in range(3):
        paddle.matmul(x, x)
    assert dispatch_cache_info() == {"entries": 0, "compiled": 0}
    dispatch_cache_clear()
    seen = []
    set_debug_hook(lambda name, outs: seen.append((name, len(outs))))
    try:
        paddle.matmul(x, x)
    finally:
        set_debug_hook(None)
    assert seen == [("matmul", 1)]


def test_the_slice_bodies_are_collected_whole():
    """Every body of the slice's three files is run, listed as not
    ported, or held by an earlier slice's parity test."""
    run = {getattr(b, "values", (b,))[0] for b in SLICE_RUN}
    assert len(SLICE_BODIES) == 43
    skipped = set(SLICE_NOT_PORTED) | set(ELSEWHERE)
    assert run | skipped == set(SLICE_BODIES)
    assert not run & skipped
    assert len(run) == 31


def _run_body(body, tmp_path):
    fname, *names = body.split("::")
    mod = _MODULES.get(fname) or _MODULES.setdefault(fname, _load(fname))
    obj = getattr(mod, names[0])
    fn = getattr(obj(), names[1]) if len(names) == 2 else obj
    kwargs = {}
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs["tmp_path"] = tmp_path
    paddle.seed(0)
    np.random.seed(0)
    fn(**kwargs)


@pytest.mark.parametrize("body", SLICE_RUN)
def test_slice_reference_body(body, tmp_path):
    _run_body(body, tmp_path)


@pytest.mark.parametrize("body", RUN)
def test_reference_body(body, tmp_path):
    fname, *names = body.split("::")
    mod = _MODULES.get(fname) or _MODULES.setdefault(fname, _load(fname))
    obj = getattr(mod, names[0])
    fn = getattr(obj(), names[1]) if len(names) == 2 else obj
    kwargs = {}
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs["tmp_path"] = tmp_path
    paddle.seed(0)
    np.random.seed(0)
    fn(**kwargs)


def test_the_feature_bodies_are_collected_whole():
    """Every body of the slice's selection is run or listed as not
    ported, with the counts of ROADMAP A23b-3b and A23b-4 (the seven
    that waited for quantization/, static/, to_static and version/ run
    since A23b-4b and A23b-5a, ``TestHybridParallelUtil`` since
    A23b-6b)."""
    counts = {}
    for b in FEATURE_BODIES:
        counts[b.split("::")[0]] = counts.get(b.split("::")[0], 0) + 1
    assert counts == {"test_namespaces_transforms.py": 7,
                      "test_sparse_depth.py": 30, "test_autograd.py": 24,
                      "test_incubate_extras.py": 6, "test_profiler.py": 5,
                      "test_api_surfaces.py": 19, "test_jit.py": 2,
                      "test_io.py": 1}
    assert set(FEATURES_NOT_PORTED) <= set(FEATURE_BODIES)
    assert len(FEATURE_RUN) == 91


def _grid(fn):
    """The keyword sets of a body's ``parametrize`` marks (one empty set
    for a body without)."""
    grid = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        grid = [dict(g, **dict(zip(names, v if len(names) > 1 else (v,))))
                for g in grid for v in values]
    return grid


@pytest.mark.parametrize("body", FEATURE_RUN)
def test_feature_reference_body(body, tmp_path):
    fname, *names = body.split("::")
    mod = _MODULES.get(fname) or _MODULES.setdefault(fname, _load(fname))
    obj = getattr(mod, names[0])
    fn = getattr(obj(), names[1]) if len(names) == 2 else obj
    for kwargs in _grid(fn):
        if "tmp_path" in inspect.signature(fn).parameters:
            kwargs["tmp_path"] = tmp_path
        paddle.seed(0)
        np.random.seed(0)
        fn(**kwargs)


# The deployment slice's bodies (ROADMAP A23b-4b and A23b-5a):
# quantization, dy2static and to_static, jit.save/load, the predictor,
# PredictorServer and the native C client, and the fleet behind the
# server.  Whole files (None) or the classes the slice ports.
DEPLOY = {
    "test_quantization_depth.py": None,
    "test_dy2static.py": None,
    "test_strings_static_cf.py": None,
    "test_hapi_inference.py": None,
    "test_infer_capi.py": None,
    "test_jit.py": ("TestFunctionalCall", "TestToStatic"),
    "test_fleet.py": ("TestFleetServing",),
}
DEPLOY_NOT_PORTED = {
    "test_quantization_depth.py::TestConvertPipeline::"
    "test_ptq_convert_to_int8_linear":
        "compares Tensor.dtype with the string 'int8'; the port's is "
        "torch.int8, held in test_torch_quantization.py",
    **{f"test_fleet.py::TestFleetServing::{t}":
       "builds gpt_tiny() and a Fleet on the default device, the card in "
       "the port; held with device='cpu' in test_torch_inference.py"
       for t in ("test_predictor_server_fleet_kwarg",
                 "test_backend_kwarg_validation")},
}
DEPLOY_BODIES = [b for b in _bodies(tuple(DEPLOY))
                 if _selected(b, DEPLOY[b.split("::")[0]])]
DEPLOY_RUN = [b for b in DEPLOY_BODIES if b not in DEPLOY_NOT_PORTED]


def test_the_deploy_bodies_are_collected_whole():
    """Every body of the slice's selection is run or listed as not
    ported, with the counts of ROADMAP A23b-4b and A23b-5a (the three
    reference-format predictor bodies run since A23b-5b)."""
    counts = {}
    for b in DEPLOY_BODIES:
        counts[b.split("::")[0]] = counts.get(b.split("::")[0], 0) + 1
    assert counts == {"test_quantization_depth.py": 8,
                      "test_dy2static.py": 68,
                      "test_strings_static_cf.py": 6,
                      "test_hapi_inference.py": 10,
                      "test_infer_capi.py": 5, "test_jit.py": 5,
                      "test_fleet.py": 2}
    assert set(DEPLOY_NOT_PORTED) <= set(DEPLOY_BODIES)
    assert len(DEPLOY_RUN) == 101


def _fixture_values(mod, fn, stack):
    """The module-level pytest fixtures ``fn`` asks for, each set up
    (a generator fixture runs to its yield; its teardown goes on
    ``stack``)."""
    kwargs = {}
    for name in inspect.signature(fn).parameters:
        fx = getattr(mod, name, None)
        wrapped = getattr(getattr(fx, "__pytest_wrapped__", None), "obj",
                          None)
        if wrapped is None and hasattr(fx, "_get_wrapped_function"):
            wrapped = fx._get_wrapped_function()
        if wrapped is None:
            continue
        val = wrapped()
        if inspect.isgenerator(val):
            gen, val = val, next(val)
            stack.callback(lambda g=gen: next(g, None))
        kwargs[name] = val
    return kwargs


@pytest.mark.parametrize("body", DEPLOY_RUN)
def test_deploy_reference_body(body, tmp_path):
    import contextlib

    fname, *names = body.split("::")
    mod = _MODULES.get(fname) or _MODULES.setdefault(fname, _load(fname))
    obj = getattr(mod, names[0])
    fn = getattr(obj(), names[1]) if len(names) == 2 else obj
    with contextlib.ExitStack() as stack:
        kwargs = _fixture_values(mod, fn, stack)
        if "tmp_path" in inspect.signature(fn).parameters:
            kwargs["tmp_path"] = tmp_path
        paddle.seed(0)
        np.random.seed(0)
        fn(**kwargs)


# The program tooling (ROADMAP A23b-5b): the ProgramDesc exporter and
# importer, custom ops and C++ extensions, and the analysis CLI's
# ``program`` lint.  A body carrying its file's ``slow`` mark keeps it.
PROGRAM = {
    "test_program_export.py": None,
    "test_program_import.py": None,
    "test_custom_op.py": None,
    "test_analysis.py": ("TestSeededBugs::test_g001_dead_op_in_program",
                         "TestGraphLintCLI::"
                         "test_cli_exported_zoo_program_clean"),
}
_PE = "test_program_export.py::"
_DEFAULT_CARD = ("builds {} on the default device, the card in the port; "
                 "held with device='cpu' in test_torch_program_export.py")
_JAX_FN = ("calls OPS[name].jax_fn, the JAX registry's body; the port's "
           "is .body, held in ")
PROGRAM_NOT_PORTED = {
    **{_PE + t: _JNP + "test_torch_program_export.py" for t in (
        "TestReviewRegressions::"
        "test_dynamic_batch_mask_broadcast_stays_elementwise",
        "TestReviewRegressions::test_tied_constant_serializes_once",
        "TestReviewRegressions::test_trunc_rem_negative_operands",
        "TestReviewRegressions::test_integer_bitwise_and_refuses",
        "TestRound5NewHandlers::test_iota_cumsum_pad_roundtrip",
        "TestRound5NewHandlers::test_split_roundtrip",
        "TestRound5NewHandlers::test_scalar_literal_unary_folds",
        "TestRound5NewHandlers::"
        "test_deferred_literal_into_cumsum_materializes",
        "TestIntLiteralPrecision::"
        "test_big_int_literal_exports_exact_str_value",
        "TestRound5ControlFlowExport::test_while_roundtrip",
        "TestRound5ControlFlowExport::"
        "test_split_dynamic_batch_axis_refuses",
        "TestRound5ControlFlowExport::test_forced_expand_reemits_per_block",
        "TestRound5BertPath::test_collapsed_literal_compare_select",
        "TestRound5GeluFusion::test_half_scaled_product_does_not_misfuse",
        "TestRound5LayerNormFusion::test_mean_reused_outside_declines",
        "TestRound5LayerNormFusion::"
        "test_shared_reduce_outside_chain_declines")},
    _PE + "TestReviewRegressions::test_select_n_three_cases_refuses":
        "calls jax.lax.select_n, a JAX primitive with no torch op (the "
        "three-way select has no aten counterpart to refuse)",
    _PE + "TestRound5Breadth::test_gpt_tiny_exports_to_reference_format":
        _DEFAULT_CARD.format("gpt_tiny()"),
    _PE + "TestRound5LlamaExport::test_llama_tiny_round_trips":
        _DEFAULT_CARD.format("llama_tiny()"),
    "test_program_import.py::TestFineTuneImported::"
    "test_grad_through_conditional_block":
        "differentiates the program with jax.grad; held with torch "
        "autograd in test_torch_program_import.py",
    **{f"test_program_import.py::TestDetectionOps::{t}":
       _JAX_FN + "test_torch_program_import.py" for t in (
           "test_yolo_box_nms_pipeline", "test_prior_box_and_box_coder")},
    "test_custom_op.py::TestOpSchema::"
    "test_every_registered_op_validates_or_is_documented":
        _JAX_FN + "test_torch_op_sweep.py's schema sweep",
    **{f"test_custom_op.py::TestAutotune::{t}":
       "the Pallas autotune cache (ops/pallas/autotune.py) is not ported "
       "by design (ROADMAP \"Not ported by design\")" for t in (
           "test_pick_flag_off_returns_heuristic",
           "test_pick_measures_and_caches_with_flag",
           "test_heuristic_entry_does_not_block_later_tuning",
           "test_failing_candidate_skipped",
           "test_validate_screens_candidates_before_measure",
           "test_validate_rejecting_all_keeps_original_list",
           "test_save_file_is_atomic",
           "test_flash_attention_still_correct")},
}
PROGRAM_BODIES = [b for b in _bodies(tuple(PROGRAM))
                  if _selected(b, PROGRAM[b.split("::")[0]])]


def _slow(body):
    """Whether the reference test carries the ``slow`` mark."""
    fname, *names = body.split("::")
    src = open(os.path.join(HERE, fname)).read()
    name = names[-1]
    m = re.search(rf"(@pytest\.mark\.\w+[^\n]*\n\s*)*def {name}\(", src)
    return m is not None and "@pytest.mark.slow" in m.group(0)


PROGRAM_RUN = [pytest.param(b, marks=pytest.mark.slow) if _slow(b) else b
               for b in PROGRAM_BODIES if b not in PROGRAM_NOT_PORTED]


def test_the_program_bodies_are_collected_whole():
    """Every body of the slice's selection is run or listed as not
    ported, with the counts of ROADMAP A23b-5b."""
    counts = {}
    for b in PROGRAM_BODIES:
        counts[b.split("::")[0]] = counts.get(b.split("::")[0], 0) + 1
    assert counts == {"test_program_export.py": 39,
                      "test_program_import.py": 32,
                      "test_custom_op.py": 21, "test_analysis.py": 2}
    assert set(PROGRAM_NOT_PORTED) <= set(PROGRAM_BODIES)
    assert len(PROGRAM_RUN) == 63


@pytest.mark.parametrize("body", PROGRAM_RUN)
def test_program_reference_body(body, tmp_path, capsys):
    fname, *names = body.split("::")
    mod = _MODULES.get(fname) or _MODULES.setdefault(fname, _load(fname))
    obj = getattr(mod, names[0])
    fn = getattr(obj(), names[1]) if len(names) == 2 else obj
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path), ("capsys", capsys))
              if k in params}
    paddle.seed(0)
    np.random.seed(0)
    fn(**kwargs)


# The communication layer (ROADMAP A23b-6a) and fleet's hybrid
# parallelism and auto_parallel (A23b-6b): the store and native runtime,
# the launcher and its elastic relaunch, rpc, the timers, the distributed
# checkpoint, the ZeRO stages, the topology, the mp layers, the meta
# optimizers, the tuner, auto_parallel and sequence parallelism.  Whole
# files (None) or the classes the slices port; a parametrised body runs
# once over its grid, a ``slow`` one keeps the mark.  A body that builds
# a ``jax.sharding.Mesh``, calls ``shard_map``, reads ``.sharding`` or
# takes a Tensor's data for the global array is listed with the port
# test that holds its fact in torch, or the part of the port it waits
# for.  The bodies of ``RANKS8`` build a topology of eight ranks (the
# JAX package's eight virtual devices): they run on every rank of a pool
# of eight gloo ranks (``torch_dist_pool``), started only for them.
DISTRIBUTED = {
    "test_native.py": None,
    "test_launch.py": None,
    "test_rpc_elastic_inference.py": ("TestRpc", "TestElasticRelaunch"),
    "test_incubate_extras.py": ("TestTimerHelper",),
    "test_checkpoint.py": None,
    "test_group_sharded.py": None,
    "test_distributed.py": None,
    "test_meta_optimizers.py": ("TestMetaOptimizers", "TestParallelTuner",
                                "TestRound4MetaOptimizers"),
    "test_auto_parallel.py": None,
    "test_sequence_parallel.py": None,
}
_MESH = "builds a jax.sharding.Mesh; held in torch in "
_SHARD_MAP = ("runs the collective inside shard_map over the 8-device "
              "mesh; held over two gloo ranks in ")
_SHARDING = "reads the jax array's .sharding; held over two gloo ranks in "
_GLOBAL = ("reads a Tensor's data as the global array; the port's is the "
           "rank's block, held over two gloo ranks in ")
_TD = "test_distributed.py::"
_TAP = "test_torch_auto_parallel.py::"
_TSP = "test_torch_sequence_parallel.py::"
_TTP = "test_torch_tensor_parallel.py::"
_SP = "test_sequence_parallel.py::"
DISTRIBUTED_NOT_PORTED = {
    "test_checkpoint.py::test_sharded_save_load_round_trip":
        _MESH + "test_torch_checkpoint.py::"
        "test_jax_mesh_checkpoint_loads_in_the_port",
    "test_checkpoint.py::test_reshard_on_load":
        _MESH + "test_torch_checkpoint.py::"
        "test_reshard_on_load_into_one_process",
    "test_checkpoint.py::test_converter_class":
        _MESH + "test_torch_checkpoint.py::test_converter_and_async_save",
    "test_group_sharded.py::test_stage3_params_physically_sharded":
        "reads the jax arrays' .sharding.device_set; held in "
        "test_torch_group_sharded.py::test_what_a_rank_holds_at_rest",
    _TD + "TestCollectives::test_all_reduce_in_shard_map":
        _SHARD_MAP + "test_torch_distributed.py::test_psum_of_the_blocks_is_28",
    _TD + "TestCollectives::test_all_gather_in_shard_map":
        _SHARD_MAP + "test_torch_distributed.py::"
        "test_all_gather_order_and_objects",
    _TD + "TestCollectives::test_reduce_scatter_in_shard_map":
        _SHARD_MAP + "test_torch_distributed.py::test_reduce_scatter_of_ones",
    _TD + "TestCollectives::test_p2p_permute_ring":
        _SHARD_MAP + "test_torch_distributed.py::"
        "test_ring_permute_is_the_roll",
    _TD + "TestCollectives::test_eager_all_reduce_sharded":
        _SHARD_MAP + "test_torch_distributed.py::test_all_reduce_ops",
    _TD + "TestSpmdTraining::test_dp_sharded_train_step":
        _MESH + "test_torch_distributed.py::"
        "test_data_parallel_matches_the_jax_dp8_step",
    _TD + "TestSpmdTraining::test_tp_forward_sharded_params":
        _SHARDING + _TTP + "test_mp_layer_matches_the_jax_layer",
    "test_meta_optimizers.py::TestParallelTuner::"
    "test_gpt124m_pick_is_sane_and_refine_measures":
        "refines on eight devices of one process through "
        "paddle_tpu.parallel's SpmdTrainStep with gpt_tiny() on the "
        "default device, the card in the port; the "
        "pick is held in " + _TAP + "test_tuner_decides_as_the_jax_tuner "
        "and refine over the world's ranks in " + _TAP +
        "test_refine_times_the_candidates_the_world_holds",
    "test_meta_optimizers.py::TestRound4MetaOptimizers::"
    "test_fp16_allreduce_quantizes_grads_before_step":
        "compares w0 - w with float16(0.1) at rtol 1e-7, which the f32 "
        "rounding of w0 - 0.1 meets only for weights below 1 in "
        "magnitude (the JAX seed's; the port's seed-0 weights hold "
        "-0.90); the gradient's fp16 round trip is held exactly in "
        "test_torch_fleet_topology.py::"
        "test_fp16_allreduce_rounds_the_gradient_through_fp16",
    "test_auto_parallel.py::test_process_mesh_basic":
        "calls ProcessMesh.jax_mesh(), which has no counterpart; held in " +
        _TAP + "test_process_mesh_equals_the_jax_one",
    **{f"test_auto_parallel.py::{t}": _SHARDING + _TAP +
       "test_shard_reshard_op_and_layer_over_two_ranks" for t in (
           "test_shard_tensor_placements",
           "test_shard_tensor_shard_spec_style",
           "test_shard_layer_replicates")},
    **{f"test_auto_parallel.py::{t}": _GLOBAL + _TAP +
       "test_shard_reshard_op_and_layer_over_two_ranks" for t in (
           "test_reshard_changes_placement",
           "test_shard_op_constrains_output")},
    _SP + "test_context_parallel_matches_dense":
        _SHARD_MAP + _TSP + "test_context_parallel_matches_jax",
    _SP + "test_context_parallel_grads":
        _SHARD_MAP + _TSP + "test_context_parallel_matches_jax",
    _SP + "test_ring_attention_uneven_heads":
        _SHARD_MAP + _TSP +
        "test_ring_takes_uneven_heads_and_ulysses_refuses_them",
    _SP + "test_ulysses_rejects_bad_heads":
        _SHARD_MAP + _TSP +
        "test_ring_takes_uneven_heads_and_ulysses_refuses_them",
    _SP + "test_gpt_context_parallel_matches_dense":
        "builds gpt_tiny() on the default device, the card in the port, "
        "over a sep mesh of 8; held over two gloo ranks in " + _TSP +
        "test_gpt_cp_forward_matches_the_jax_cp_model",
    _SP + "test_gpt_context_parallel_eager_backward":
        "builds gpt_tiny() on the default device, the card in the port, "
        "over a sep mesh of 8; held over two gloo ranks in " + _TSP +
        "test_gpt_cp_eager_backward_matches_jax",
    _SP + "test_gpt_sequence_parallel_flag_runs":
        "builds gpt_tiny() on the default device, the card in the port, "
        "over an mp mesh of 8; held over two gloo ranks in " + _TTP +
        "test_gpt_mp2_three_clipped_adamw_steps_match_jax",
    _SP + "test_mark_sequence_sharded_under_jit":
        "constrains a jax array under jax.jit; held over two gloo ranks "
        "in " + _TSP + "test_sequence_marks_split_and_gather",
}
RANKS8 = (_TD + "TestTopology::test_hcg_mesh",
          _TD + "TestFleetInit::test_fleet_init_builds_hcg",
          "test_meta_optimizers.py::TestParallelTuner::"
          "test_mapper_builds_mesh")
DISTRIBUTED_BODIES = [b for b in _bodies(tuple(DISTRIBUTED))
                      if _selected(b, DISTRIBUTED[b.split("::")[0]])]
DISTRIBUTED_RUN = [pytest.param(b, marks=pytest.mark.slow) if _slow(b)
                   else b for b in DISTRIBUTED_BODIES
                   if b not in DISTRIBUTED_NOT_PORTED and b not in RANKS8]


def test_the_distributed_bodies_are_collected_whole():
    """Every body of the slices' selection is run (here or on eight
    ranks) or listed as not ported, with the counts of ROADMAP A23b-6a
    and A23b-6b; none waits for A23b-6b."""
    counts = {}
    for b in DISTRIBUTED_BODIES:
        counts[b.split("::")[0]] = counts.get(b.split("::")[0], 0) + 1
    assert counts == {"test_native.py": 11, "test_launch.py": 3,
                      "test_rpc_elastic_inference.py": 6,
                      "test_incubate_extras.py": 1,
                      "test_checkpoint.py": 7, "test_group_sharded.py": 4,
                      "test_distributed.py": 13,
                      "test_meta_optimizers.py": 23,
                      "test_auto_parallel.py": 8,
                      "test_sequence_parallel.py": 8}
    assert set(DISTRIBUTED_NOT_PORTED) <= set(DISTRIBUTED_BODIES)
    assert set(RANKS8) <= set(DISTRIBUTED_BODIES)
    assert not set(RANKS8) & set(DISTRIBUTED_NOT_PORTED)
    assert len(DISTRIBUTED_RUN) == 54
    assert all("test_torch_" in why
               for why in DISTRIBUTED_NOT_PORTED.values())
    listed = (DISTRIBUTED_NOT_PORTED, FEATURES_NOT_PORTED, SLICE_NOT_PORTED)
    assert not any("A23b-6b" in why for d in listed for why in d.values())


def _run_distributed_body(body, tmp_path, capsys):
    fname, *names = body.split("::")
    mod = _MODULES.get(fname) or _MODULES.setdefault(fname, _load(fname))
    obj = getattr(mod, names[0])
    fn = getattr(obj(), names[1]) if len(names) == 2 else obj
    params = inspect.signature(fn).parameters
    for kwargs in _grid(fn):
        kwargs.update((k, v) for k, v in (("tmp_path", tmp_path),
                                          ("capsys", capsys)) if k in params)
        if "monkeypatch" in params:
            with pytest.MonkeyPatch.context() as mp:
                kwargs["monkeypatch"] = mp
                paddle.seed(0)
                np.random.seed(0)
                fn(**kwargs)
            continue
        paddle.seed(0)
        np.random.seed(0)
        fn(**kwargs)


@pytest.mark.parametrize("body", DISTRIBUTED_RUN)
def test_distributed_reference_body(body, tmp_path, capsys):
    _run_distributed_body(body, tmp_path, capsys)


def run_on_a_rank(body):
    """One body of ``RANKS8`` on this rank of a ``torch_dist_pool``
    pool (a task: the pool's ranks import this module)."""
    _run_distributed_body(body, None, None)
    return True


@pytest.fixture(scope="module")
def pool8():
    import torch_dist_pool as TP

    pool = TP.RankPool(8, timeout=120)
    yield pool
    pool.close()


@pytest.mark.parametrize("body", RANKS8)
def test_distributed_reference_body_on_eight_ranks(body, pool8):
    assert pool8.run(run_on_a_rank, body) == [True] * 8


# The tensor-parallel engine's analysis (ROADMAP A20b, one card): the JAX
# package's tp=2 engine-grid, CLI and census bodies.  Each builds
# gpt_tiny() and an LLMEngine(tensor_parallel=2) on the default device,
# the card in the port (its ranks on cuda:0 and cuda:1), so none runs on
# the CPU here; each is listed with the port test that holds its fact on
# CPU ranks.
TP_ANALYSIS = {
    "test_analysis.py": ("TestCleanRuns::test_engine_grid_zero_findings_tp2",
                         "TestGraphLintCLI::test_cli_engine_grid_clean",
                         "TestGraphLintCLI::test_cli_engine_spec_grid_clean"),
    "test_cost.py": ("TestCensus::test_census_tp2_clean",),
}
_TPA = "test_torch_tp_analysis.py::"
_TP_CARD = ("builds gpt_tiny() and a tensor_parallel=2 engine on the default "
            "device, the card in the port; held on two CPU ranks in ")
TP_ANALYSIS_NOT_PORTED = {
    "test_analysis.py::TestCleanRuns::test_engine_grid_zero_findings_tp2":
        _TP_CARD + _TPA + "test_analyze_engine_tp2_zero_findings",
    "test_analysis.py::TestGraphLintCLI::test_cli_engine_grid_clean":
        _TP_CARD + _TPA + "test_cli_engine_tp2_clean",
    "test_analysis.py::TestGraphLintCLI::test_cli_engine_spec_grid_clean":
        _TP_CARD + _TPA + "test_cli_engine_tp2_clean",
    "test_cost.py::TestCensus::test_census_tp2_clean":
        _TP_CARD + _TPA + "test_census_tp2_clean_with_derived_collective_bytes",
}
TP_ANALYSIS_BODIES = [b for b in _bodies(tuple(TP_ANALYSIS))
                      if _selected(b, TP_ANALYSIS[b.split("::")[0]])]


def test_the_tp_analysis_bodies_are_listed_whole():
    """The four tp=2 bodies are each listed with a port test that
    exists."""
    assert sorted(TP_ANALYSIS_BODIES) == sorted(TP_ANALYSIS_NOT_PORTED)
    src = open(os.path.join(HERE, _TPA[:-2])).read()
    for why in TP_ANALYSIS_NOT_PORTED.values():
        name = why.rsplit("::", 1)[1]
        assert re.search(rf"^def {name}\(", src, re.M), name
