"""The port's concurrency lint (R001-R005,
``paddle_tpu_torch/framework/concurrency_lint.py``), a copy of the JAX
package's module.

The JAX module's own battery (``tests/test_concurrency_lint.py``, each
rule on a seeded bug and on its annotated benign variant) runs against
the copy: the battery's classes are loaded from that file under another
name, with its ``check_concurrency`` pointed at the port's.  The copy
may differ from the JAX module only where the port forces it: the
import of ``Finding`` from the port's ``analysis``, ``default_paths``
(the port's ``inference/llm``, ``framework``, ``sim`` and ``jit``) and
``_BLOCKING_SIMPLE``, which gains torch's device syncs so that R003
finds a ``torch.cuda.synchronize()`` under a lock.  ``threads --strict``
over the port's tree is clean.
"""

import ast
import importlib.util
import inspect
import json
import os

from paddle_tpu.framework import concurrency_lint as jax_lint
from paddle_tpu_torch.framework import analysis
from paddle_tpu_torch.framework import concurrency_lint as port_lint

_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "test_concurrency_lint.py")


def _battery():
    spec = importlib.util.spec_from_file_location(
        "_concurrency_battery_on_the_port", _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.check_concurrency = port_lint.check_concurrency
    return mod


_ref = _battery()


class TestR001OnThePort(_ref.TestR001LockDiscipline):
    pass


class TestR002OnThePort(_ref.TestR002LockOrder):
    pass


class TestR003OnThePort(_ref.TestR003BlockingWhileLocked):
    pass


class TestR004OnThePort(_ref.TestR004EpochDiscipline):
    pass


class TestR005OnThePort(_ref.TestR005StaleSuppressions):
    pass


def _top(mod):
    src = inspect.getsource(mod)
    body = ast.parse(src).body
    nodes = []
    for n in body:
        if isinstance(n, ast.Assign):
            name = ast.unparse(n.targets[0])
        elif isinstance(n, ast.ImportFrom):
            name = f"from {'.' * n.level}{n.module}"
        else:
            name = getattr(n, "name", None)
        nodes.append((name, ast.get_source_segment(src, n)))
    return nodes


_PORTED = {"from .analysis", "default_paths", "_BLOCKING_SIMPLE"}


def test_copy_differs_only_where_the_port_forces():
    jax_nodes, port_nodes = _top(jax_lint), _top(port_lint)
    assert [n for n, _ in jax_nodes] == [n for n, _ in port_nodes]
    for (name, jtext), (_, ptext) in zip(jax_nodes, port_nodes):
        if name not in _PORTED:
            assert jtext == ptext, name
    # the blocking table only grows, by device syncs
    jax_table, port_table = jax_lint._BLOCKING_SIMPLE, \
        port_lint._BLOCKING_SIMPLE
    assert {k: v for k, v in port_table.items() if k in jax_table} == \
        jax_table
    added = {k: v for k, v in port_table.items() if k not in jax_table}
    assert ("cuda", "synchronize") in added
    assert set(added.values()) == {"device-sync"}
    assert all(k[1] == "synchronize" for k in added)


def test_default_paths_cover_the_port_serving_tree():
    tails = sorted(p.replace("\\", "/").rsplit("paddle_tpu_torch/", 1)[-1]
                   for p in port_lint.default_paths())
    assert tails == ["framework", "inference/llm", "jit", "sim"]


_LOCKED_SYNC = """\
import threading

import torch


class W:
    def __init__(self):
        self._lock = threading.Lock()

    def stall(self, x):
        with self._lock:
            torch.cuda.synchronize()
            return x
"""


def test_r003_finds_a_cuda_synchronize_under_a_lock(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(_LOCKED_SYNC)
    found = [f for f in port_lint.check_concurrency([str(p)])
             if f.rule == "R003"]
    assert [f.category for f in found] == ["device-sync"]
    assert "while holding ['_lock']" in found[0].message
    # the JAX module does not know torch's device sync
    assert [f for f in jax_lint.check_concurrency([str(p)])
            if f.rule == "R003"] == []
    # outside the lock: clean; tagged with a reason: clean
    p.write_text(_LOCKED_SYNC.replace(
        "            torch.cuda.synchronize()\n            return x",
        "            y = x\n        torch.cuda.synchronize()\n"
        "        return y"))
    assert [f for f in port_lint.check_concurrency([str(p)])
            if f.rule == "R003"] == []
    p.write_text(_LOCKED_SYNC.replace(
        "torch.cuda.synchronize()",
        "torch.cuda.synchronize()  # noqa: R003 (shutdown only)"))
    assert port_lint.check_concurrency([str(p)]) == []


def test_cli_threads_exit_codes(tmp_path, capsys):
    p = tmp_path / "buggy.py"
    p.write_text(_ref.TestR001LockDiscipline.BUGGY)
    assert analysis.main(["threads", str(p)]) == 1
    assert "R001" in capsys.readouterr().out
    assert analysis.main(["threads", "--json", str(p)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["errors"] == 2 and {f["rule"] for f in doc["findings"]} == \
        {"R001"}
    stale = tmp_path / "stale.py"
    stale.write_text("class W:\n"
                     "    def quiet(self):\n"
                     "        return 1  # noqa: R001 (stale)\n")
    assert analysis.main(["threads", str(stale)]) == 0
    assert analysis.main(["threads", "--strict", str(stale)]) == 1


def test_threads_strict_is_clean_over_the_port(capsys):
    assert port_lint.ALL_RULES == ("R001", "R002", "R003", "R004", "R005")
    rc = analysis.main(["threads", "--strict"])
    out = capsys.readouterr().out
    assert rc == 0, f"concurrency lint regressed:\n{out}"
    assert port_lint.check_concurrency() == []
