"""The port imports neither ``jax`` nor anything of the JAX package.

Checked two ways: a fresh interpreter imports the port's entry modules
and must end up with no ``jax``, no ``paddle_tpu`` and no
``google.protobuf`` module loaded (the port's ONNX codec is its own)
(``paddle_tpu_torch`` itself shares the prefix, so names are matched
exactly or up to a dot); and an AST scan of every port source file and
``chip_smoke.py`` finds no such import statement.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "paddle_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    return sorted(paths)


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "paddle_tpu" or name.startswith("paddle_tpu."))


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.inference.llm\n"
        "import paddle_tpu_torch.models.gpt\n"
        "import paddle_tpu_torch.ops.cuda.registry\n"
        "import paddle_tpu_torch.nn.functional, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.ops.attention\n"
        "import paddle_tpu_torch.ops.cuda.flash_attention_kernel\n"
        "import paddle_tpu_torch.ops.cuda.layernorm_kernel\n"
        "import paddle_tpu_torch.ops.cuda.decode_attention_kernel\n"
        "import paddle_tpu_torch.models.llama, paddle_tpu_torch.incubate.nn\n"
        "import paddle_tpu_torch.inference.llm.quality\n"
        "import paddle_tpu_torch.framework.cost\n"
        "import paddle_tpu_torch.inference.llm.lora\n"
        "import paddle_tpu_torch.inference.llm.kv_tier\n"
        "import paddle_tpu_torch.sim.workloads\n"
        "import paddle_tpu_torch.inference.llm.fleet\n"
        "import paddle_tpu_torch.sim, paddle_tpu_torch.sim.simulator\n"
        "import paddle_tpu_torch.inference.llm.tensor_parallel\n"
        "import paddle_tpu_torch.framework.analysis\n"
        "import paddle_tpu_torch.framework.kernel_lint\n"
        "import paddle_tpu_torch.framework.concurrency_lint\n"
        "import paddle_tpu_torch.core.tensor, paddle_tpu_torch.autograd\n"
        "import paddle_tpu_torch.quantization, paddle_tpu_torch.static\n"
        "import paddle_tpu_torch.jit.dy2static\n"
        "import paddle_tpu_torch.jit.save_load\n"
        "import paddle_tpu_torch.framework.ir, paddle_tpu_torch.version\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.ops.dispatch, paddle_tpu_torch.ops.registry\n"
        "import paddle_tpu_torch.ops.creation, paddle_tpu_torch.ops.math\n"
        "import paddle_tpu_torch.ops.manipulation, paddle_tpu_torch.ops.logic\n"
        "import paddle_tpu_torch.ops.random, paddle_tpu_torch.ops.waiting\n"
        "import paddle_tpu_torch.nn.layer_base, paddle_tpu_torch.nn.loss\n"
        "import paddle_tpu_torch.nn.transformer, paddle_tpu_torch.nn.common\n"
        "import paddle_tpu_torch.models.bert, paddle_tpu_torch.framework_io\n"
        "import paddle_tpu_torch.autograd.py_layer\n"
        "import paddle_tpu_torch.ops.linalg, paddle_tpu_torch.ops.pool_ops\n"
        "import paddle_tpu_torch.linalg, paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.nn.conv, paddle_tpu_torch.nn.pooling\n"
        "import paddle_tpu_torch.nn.norm, paddle_tpu_torch.metric\n"
        "import paddle_tpu_torch.io, paddle_tpu_torch.io.dataloader\n"
        "import paddle_tpu_torch.io.device_prefetch\n"
        "import paddle_tpu_torch.hapi, paddle_tpu_torch.hapi.model\n"
        "import paddle_tpu_torch.hapi.flops, paddle_tpu_torch.hapi.callbacks\n"
        "import paddle_tpu_torch.vision, paddle_tpu_torch.vision.models\n"
        "import paddle_tpu_torch.vision.transforms\n"
        "import paddle_tpu_torch.ops.misc_ops, paddle_tpu_torch.ops.optim_ops\n"
        "import paddle_tpu_torch.ops.fused_ops, paddle_tpu_torch.ops.seq_ops\n"
        "import paddle_tpu_torch.ops.vision_ops, paddle_tpu_torch.ops.fft_ops\n"
        "import paddle_tpu_torch.ops.sparse_ops, paddle_tpu_torch.ops.graph_ops\n"
        "import paddle_tpu_torch.ops.conv_extra\n"
        "import paddle_tpu_torch.fft, paddle_tpu_torch.signal\n"
        "import paddle_tpu_torch.incubate.nn.functional\n"
        "import paddle_tpu_torch.nn.rnn, paddle_tpu_torch.audio\n"
        "import paddle_tpu_torch.audio.features, paddle_tpu_torch.audio.functional\n"
        "import paddle_tpu_torch.models.conformer\n"
        "import paddle_tpu_torch.models.deepspeech, paddle_tpu_torch.text\n"
        "import paddle_tpu_torch.vision.datasets\n"
        "import paddle_tpu_torch.vision.models.vgg\n"
        "import paddle_tpu_torch.vision.models.mobilenetv2\n"
        "import paddle_tpu_torch.vision.models.densenet\n"
        "import paddle_tpu_torch.vision.models.squeezenet\n"
        "import paddle_tpu_torch.vision.models.shufflenetv2\n"
        "import paddle_tpu_torch.vision.models.inception\n"
        "import paddle_tpu_torch.core.native, paddle_tpu_torch.strings\n"
        "import paddle_tpu_torch.framework.memory\n"
        "import paddle_tpu_torch.profiler, paddle_tpu_torch.amp.debugging\n"
        "import paddle_tpu_torch.incubate.autograd\n"
        "import paddle_tpu_torch.incubate.optimizer\n"
        "import paddle_tpu_torch.incubate.asp, paddle_tpu_torch.incubate\n"
        "import paddle_tpu_torch.tensor_array, paddle_tpu_torch.geometric\n"
        "import paddle_tpu_torch.distribution\n"
        "import paddle_tpu_torch.distribution.transform\n"
        "import paddle_tpu_torch.sparse, paddle_tpu_torch.sparse.depth\n"
        "import paddle_tpu_torch.sparse.conv\n"
        "import paddle_tpu_torch.static.program_import\n"
        "import paddle_tpu_torch.static.program_export\n"
        "import paddle_tpu_torch.onnx, paddle_tpu_torch.onnx.export\n"
        "import paddle_tpu_torch.onnx.runtime\n"
        "import paddle_tpu_torch.onnx.onnx_subset_pb2\n"
        "import paddle_tpu_torch.utils, paddle_tpu_torch.utils.custom_op\n"
        "import paddle_tpu_torch.utils.cpp_extension\n"
        "import paddle_tpu_torch.cost_model\n"
        "import paddle_tpu_torch.distributed.group\n"
        "import paddle_tpu_torch.distributed.communication\n"
        "import paddle_tpu_torch.distributed.parallel\n"
        "import paddle_tpu_torch.distributed.checkpoint\n"
        "import paddle_tpu_torch.distributed.sharding\n"
        "import paddle_tpu_torch.distributed.store\n"
        "import paddle_tpu_torch.distributed.spawn\n"
        "import paddle_tpu_torch.distributed.rpc\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "import paddle_tpu_torch.distributed.launch.main\n"
        "import paddle_tpu_torch.distributed.fleet\n"
        "import paddle_tpu_torch.distributed.fleet.utils\n"
        "import paddle_tpu_torch.distributed.fleet.utils.timer_helper\n"
        "import paddle_tpu_torch.distributed.fleet.distributed_strategy\n"
        "import paddle_tpu_torch.distributed.fleet.elastic\n"
        "import paddle_tpu_torch.distributed.auto_parallel\n"
        "import paddle_tpu_torch.distributed.auto_parallel.strategy\n"
        "import paddle_tpu_torch.distributed.ps\n"
        "import paddle_tpu_torch.distributed.ps.service\n"
        "import paddle_tpu_torch.distributed.ps.graph\n"
        "import paddle_tpu_torch.distributed.ps.heter\n"
        "import paddle_tpu_torch.distributed.fleet.dataset\n"
        "import paddle_tpu_torch.parallel, paddle_tpu_torch.parallel.pipeline\n"
        "import paddle_tpu_torch.parallel.trainer\n"
        "import paddle_tpu_torch.incubate.distributed.models.moe\n"
        "import paddle_tpu_torch.incubate.distributed.models.moe.gate\n"
        "import paddle_tpu_torch.incubate.distributed.models.moe.moe_layer\n"
        "import paddle_tpu_torch.incubate.distributed.models.moe.grad_clip\n"
        "import paddle_tpu_torch.models.deepfm\n"
        "import paddle_tpu_torch.models.wide_deep\n"
        "import paddle_tpu_torch.distributed.fleet.topology\n"
        "import paddle_tpu_torch.distributed.fleet.spmd\n"
        "import paddle_tpu_torch.distributed.fleet.recompute\n"
        "import paddle_tpu_torch.distributed.fleet.meta_optimizers\n"
        "import paddle_tpu_torch.distributed.fleet.hybrid_parallel_optimizer\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel."
        "sequence_parallel\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel."
        "pipeline_parallel\n"
        "import paddle_tpu_torch.distributed.fleet.utils."
        "hybrid_parallel_util\n"
        "import paddle_tpu_torch.distributed.auto_parallel.tuner\n"
        "import paddle_tpu_torch.distributed.auto_parallel.engine\n"
        "import paddle_tpu_torch.distributed.auto_parallel.interface\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.') or m == 'google.protobuf' or "
        "m.startswith('google.protobuf.'))\n"
        "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"
