"""The port's graph lint, host-sync lint and capture guard
(``paddle_tpu_torch/framework/analysis.py``).

Each rule fires on one seeded bug and stays quiet on its clean control:
T001 (a float64 value, an int8 widened to float64), G001 (a dead node
and a dead chain, an in-place pool write exempt), D001 (a pool or weight
replaced after the step graphs were built, in-place writes clean), S001
(shards that drop columns or split heads at the engine's tp, a leaf off
the engine's device) and H001 (``.item()`` and the torch forms, the
``noqa`` grammar).  H001 gives the JAX ``check_host_sync``'s sites on a
source that uses only the forms both share.  ``analyze_engine`` gives no
finding over the bf16, int8, n-gram-speculation and LoRA engines of
``gpt_tiny(num_layers=2)`` on the CPU and leaves their pools, stats and
block manager as they were; the graph of a bucket holds one B1 node a
layer.  ``CaptureWatcher`` is held to a stub ``StepGraphs``, and
``warmup()`` returns one on the engine and the fleet.  The CLI's exit
codes 0, 1 and 2, ``--json`` and ``--strict``.
"""

import copy
import gc
import json
import textwrap
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu.framework import analysis as jax_analysis
from paddle_tpu_torch.framework import analysis
from paddle_tpu_torch.inference.llm import Fleet, LLMEngine
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops.cuda import registry

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16,
              device="cpu")
ENGINE_KINDS = {
    "bf16": dict(dtype="bfloat16"),
    "int8": dict(quantize="int8"),
    "ngram_spec": dict(speculative=2),
    "lora": dict(lora=dict(rank=4, max_adapters=3)),
}


@pytest.fixture(scope="module")
def model():
    return gpt_tiny(device="cpu", num_layers=2, seed=0).eval()


def _rules(findings):
    return sorted({f.rule for f in findings})


# ----------------------------------------------------------------- T001 --
def test_t001_fires_on_float64_and_stays_quiet_on_float32():
    def leak(x):
        return (x.double() * 2).sum()

    def clean(x):
        return (x * 2).sum()

    x = torch.ones(4, 8)
    found = analysis.analyze_fn(leak, x, rules=("T001",))
    assert found and _rules(found) == ["T001"]
    assert all("float64" in f.message for f in found)
    assert analysis.analyze_fn(clean, x, rules=("T001",)) == []


def test_t001_names_an_int8_widened_to_float64():
    def dequant(w8, s):
        return w8.to(torch.float64) * s

    w8 = torch.ones(4, 4, dtype=torch.int8)
    found = analysis.analyze_fn(dequant, w8, torch.ones(4),
                                rules=("T001",))
    assert any("int8" in f.message and "widens" in f.message
               for f in found)


# ----------------------------------------------------------------- G001 --
def test_g001_finds_dead_nodes_and_chains_not_pool_writes():
    def body(x, pool, idx):
        pool.index_copy_(0, idx, x)          # an effect: never dead
        dead = torch.exp(x) + 1.0            # a dead chain of two nodes
        del dead
        return (x * 2).sum()

    def clean(x, pool, idx):
        pool.index_copy_(0, idx, x)
        return (x * 2).sum()

    args = (torch.ones(2, 4), torch.zeros(6, 4), torch.tensor([1, 3]))
    found = analysis.analyze_fn(body, *args, rules=("G001",))
    assert len(found) == 2 and _rules(found) == ["G001"]
    assert {"exp", "add"} <= {f.message.split("'")[1].split(".")[1]
                              for f in found}
    assert analysis.analyze_fn(clean, *args, rules=("G001",)) == []


def test_trace_graph_leaves_the_real_pool_untouched():
    pool = torch.zeros(6, 4)

    def body(x, pool):
        pool.index_copy_(0, torch.tensor([2]), x)
        return pool.sum()

    gm = analysis.trace_graph(body, torch.ones(1, 4), pool)
    assert torch.count_nonzero(pool) == 0
    assert any("index_copy_" in str(n.target) for n in gm.graph.nodes)


# ----------------------------------------------------------------- D001 --
def test_d001_fires_when_captured_state_moves(model):
    eng = LLMEngine(model, **ENGINE)
    eng.warmup()
    assert analysis.check_captured_state(eng) == []
    # in place: still the recorded addresses
    eng._kc.zero_()
    eng._shard.params["blocks"]["attn.qkv.weight"].mul_(1.0)
    assert analysis.check_captured_state(eng) == []
    # a replaced pool and a replaced weight leaf: a replay would read the
    # old memory
    pools = eng._shard.pools
    eng._shard.pools = pools._replace(k_rows=pools.k_rows.clone())
    blocks = eng._shard.params["blocks"]
    blocks["mlp.fc_in.weight"] = blocks["mlp.fc_in.weight"].clone()
    found = analysis.check_captured_state(eng)
    assert _rules(found) == ["D001"]
    moved = {f.where.split("/", 1)[1] for f in found}
    assert moved == {"pools.k_rows", "params.blocks.mlp.fc_in.weight"}


# ----------------------------------------------------------------- S001 --
def test_s001_fires_on_shards_that_drop_columns_or_split_heads(model):
    eng = LLMEngine(model, **ENGINE)
    kw = dict(num_heads=eng.num_heads, head_dim=eng.head_dim)
    assert analysis.check_placements(eng.params, 2, **kw) == []
    assert analysis.check_placements(eng.params, 4, **kw) == []
    # tp=3: 4 heads and 256 fc_in columns do not split over 3 ranks
    found = analysis.check_placements(eng.params, 3, **kw)
    assert _rules(found) == ["S001"]
    text = " ".join(f.message for f in found)
    assert "heads do not split" in text and "land on no rank" in text
    assert any("mlp.fc_in.weight" in f.where for f in found)


def test_s001_fires_on_a_leaf_off_the_engine_device(model):
    eng = LLMEngine(model, **ENGINE)
    kw = dict(num_heads=eng.num_heads, head_dim=eng.head_dim)
    assert analysis.check_placements(eng.params, 1, device="cpu",
                                     **kw) == []
    params = {g: dict(sub) for g, sub in eng.params.items()}
    params["head"]["weight"] = params["head"]["weight"].to("meta")
    found = analysis.check_placements(params, 1, device="cpu", **kw)
    assert len(found) == 1 and found[0].rule == "S001"
    assert "head.weight" in found[0].where


# ----------------------------------------------------------------- H001 --
_SHARED_FORMS = '''
    import numpy as np


    def op(x, y, n=3):
        a = x.item()
        b = y.tolist()
        c = float(x)
        d = int(y)
        e = bool(x * 2)
        f = np.asarray(x)
        g = np.array(y)
        h = int(x.shape[0])             # metadata: not a sync
        i = x.item()  # noqa: H001 (host by contract)
        return a, b, c, d, e, f, g, h, i, n


    def host(values):
        return [int(v) for v in values]
'''


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    return str(path)


def test_h001_gives_the_jax_sites_on_the_shared_forms(tmp_path):
    path = _write(tmp_path, "shared.py", _SHARED_FORMS)
    got = [(s.line, s.category, s.allowed)
           for s in analysis.collect_host_sync_sites([path])]
    want = [(s.line, s.category, s.allowed)
            for s in jax_analysis.collect_host_sync_sites([path])]
    assert got == want
    assert len(got) == 8 and sum(1 for *_, ok in got if ok) == 1
    assert [f.where.rsplit(":", 1)[1]
            for f in analysis.check_host_sync([path])] == \
        [f.where.rsplit(":", 1)[1]
         for f in jax_analysis.check_host_sync([path])]


def test_h001_torch_forms_and_the_noqa_grammar(tmp_path):
    dirty = _write(tmp_path, "dirty.py", '''
        import torch


        def pull(x, stream):
            a = x.cpu()
            b = x.numpy()
            torch.cuda.synchronize()
            stream.synchronize()
            return a, b
    ''')
    cats = sorted(f.category for f in analysis.check_host_sync([dirty]))
    assert cats == ["explicit-sync", "explicit-sync", "to-host", "to-host"]
    tagged = _write(tmp_path, "tagged.py", '''
        import torch


        def pull(x):
            torch.cuda.synchronize()  # noqa: H001 (warmup only)
            return x.cpu()  # noqa: H001 (host by contract)
    ''')
    assert analysis.check_host_sync([tagged]) == []
    module = _write(tmp_path, "module.py", '''
        # noqa-module: H001 (host bookkeeping by design)


        def pull(x):
            return x.item()
    ''')
    assert analysis.check_host_sync([module]) == []


def test_h001_sweep_of_the_port_is_clean():
    assert analysis.check_host_sync() == []


# ------------------------------------------------------ analyze_engine --
def _snapshot(eng):
    pools = [t.clone() for t in eng._pools if t is not None]
    books = {k: copy.deepcopy(v) for k, v in vars(eng.block_manager).items()
             if not callable(v)}
    return (pools, dict(eng.stats), books, eng._graphs.captures)


@pytest.mark.parametrize("kind", sorted(ENGINE_KINDS))
def test_analyze_engine_is_clean_and_touches_nothing(model, kind):
    eng = LLMEngine(model, **ENGINE, **ENGINE_KINDS[kind])
    eng.warmup()
    prompt = np.arange(3, 14, dtype=np.int32)
    eng.generate([prompt], max_new_tokens=3)
    before = _snapshot(eng)
    assert analysis.analyze_engine(eng) == []
    after = _snapshot(eng)
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    assert before[1:] == after[1:]


def test_a_bucket_graph_holds_one_b1_node_a_layer(model):
    eng = LLMEngine(model, **ENGINE)
    op = registry.KERNELS["paged_ragged_attention"].op._opoverload
    for kind, bucket, body, operands in eng.executable_grid():
        gm = analysis.trace_graph(body, *operands)
        nodes = [n for n in gm.graph.nodes if n.target == op]
        assert len(nodes) == eng.num_layers, (kind, bucket)
        assert nodes[0].meta["val"].shape == (bucket, eng.num_heads,
                                              eng.head_dim)


def test_analyze_engine_raises_at_tp_above_one():
    class TwoRanks:
        tp = 2

    with pytest.raises(NotImplementedError, match="A20b"):
        analysis.analyze_engine(TwoRanks())


# -------------------------------------------------------- CaptureWatcher --
class _StubGraphs:
    def __init__(self):
        self.captures = 0
        self.capture_ms = {}

    def capture(self, key):
        self.captures += 1
        self.capture_ms[key] = 1.0


def test_capture_watcher_over_a_stub():
    g, d = _StubGraphs(), _StubGraphs()
    g.capture(8)
    watcher = analysis.CaptureWatcher(g, d, labels=["ragged", "draft"])
    watcher.assert_no_new_captures()
    d.capture(16)
    assert watcher.new_captures() == [("draft", 1)]
    assert watcher.new_keys() == [("draft", 16)]
    with pytest.raises(analysis.RecaptureError, match="draft: \\+1"):
        watcher.assert_no_new_captures()
    with analysis.CaptureWatcher(g) as w:      # re-armed on entry
        pass
    assert w.new_captures() == []
    with pytest.raises(analysis.RecaptureError):
        with analysis.CaptureWatcher(g):
            g.capture(32)
    loose = analysis.CaptureWatcher(g, strict=False)
    with loose:
        g.capture(64)                          # strict=False: no raise
    assert loose.new_captures() == [("graphs0", 1)]


def test_warmup_returns_an_armed_watcher(model):
    eng = LLMEngine(model, **ENGINE, speculative=dict(
        method="draft-model", num_tokens=2, draft_layers=1))
    watcher = eng.warmup()
    assert isinstance(watcher, analysis.CaptureWatcher)
    assert list(watcher.compile_ms) == ["ragged[8]", "ragged[16]"]
    assert eng.warmup_compile_ms == watcher.compile_ms
    assert watcher._labels == ["ragged", "draft"]
    eng.generate([np.arange(3, 12, dtype=np.int32)], max_new_tokens=3)
    watcher.assert_no_new_captures()


def test_fleet_warmup_returns_one_watcher_over_every_replica(model):
    fleet = Fleet(model, replicas=2, **ENGINE)
    watcher = fleet.warmup()
    assert isinstance(watcher, analysis.CaptureWatcher)
    assert sorted(watcher.compile_ms) == [0, 1]
    assert watcher._labels == ["replica0.ragged", "replica1.ragged"]
    fleet.replicas[1].engine._graphs.captures += 1    # a stray capture
    with pytest.raises(analysis.RecaptureError, match="replica1"):
        watcher.assert_no_new_captures()
    # the watcher holds the graphs weakly: a replica the fleet drops is
    # freed, and its graphs drop out of the window
    dead = weakref.ref(fleet.replicas[1].engine)
    fleet.replicas[1].engine = None
    gc.collect()
    assert dead() is None
    watcher.assert_no_new_captures()


# ------------------------------------------------------------------- CLI --
def test_cli_exit_codes_json_and_strict(tmp_path, capsys, monkeypatch):
    clean = _write(tmp_path, "clean.py", '''
        def op(x):
            return x.shape
    ''')
    dirty = _write(tmp_path, "dirty.py", '''
        def op(x):
            return x.item()
    ''')
    assert analysis.main(["ops", clean]) == 0
    assert analysis.main(["ops", dirty]) == 1
    capsys.readouterr()
    assert analysis.main(["ops", dirty, "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["errors"] == 1 and doc["findings"][0]["rule"] == "H001"
    with pytest.raises(SystemExit) as exc:
        analysis.main(["no-such-command"])
    assert exc.value.code == 2
    # a warning-only graph: 0, or 1 under --strict
    _write(tmp_path, "deadmod.py", '''
        import torch


        def dead(x):
            y = torch.exp(x)
            return x * 2
    ''')
    monkeypatch.syspath_prepend(str(tmp_path))
    args = ["fn", "deadmod:dead", "--arg", "f32[2,4]"]
    assert analysis.main(args) == 0
    assert analysis.main(args + ["--strict"]) == 1
    out = capsys.readouterr().out
    assert "G001 warning" in out


def test_cli_engine_on_the_cpu_is_clean(capsys):
    assert analysis.main(["engine", "--device", "cpu"]) == 0
    assert analysis.main(["engine", "--device", "cpu", "--quantize",
                          "int8", "--lora", "2", "--spec", "2"]) == 0
    assert "0 error(s), 0 warning(s)" in capsys.readouterr().out


def test_cli_build_reaches_the_default_device(monkeypatch):
    """``--device`` defaults to cuda: without a card the engine build
    raises as every port entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analysis.main(["engine"])
