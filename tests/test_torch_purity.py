"""The port imports neither ``jax`` nor anything of the JAX package.

Checked two ways: a fresh interpreter imports the port's entry modules
and must end up with no ``jax`` and no ``paddle_tpu`` module loaded
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
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
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
