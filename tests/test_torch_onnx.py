"""The port's ONNX export, its own wire codec and its numpy runtime,
held against the JAX package's (``paddle_tpu/onnx``).

The codec: the JAX package's protobuf ``onnx_subset_pb2`` (only this
test imports protobuf) parses the port's bytes into messages that
serialize back to the same bytes, and the port's codec does the same
with the JAX exporter's bytes; a message using every field kind
serializes to the bytes protobuf writes.  The runtime: the port's
``runtime.run`` on a JAX export equals the JAX runtime's output, and the
port's export of the same weights through the JAX runtime gives the
JAX model's output.  Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.onnx import onnx_subset_pb2 as jpb
from paddle_tpu.onnx import runtime as jrt
from paddle_tpu_torch import nn
from paddle_tpu_torch.onnx import onnx_subset_pb2 as ppb
from paddle_tpu_torch.onnx import runtime as prt
from torch_ref_helpers import jax_forward, jax_twin

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def _net(ns):
    class Net(ns.Layer):
        def __init__(self):
            super().__init__()
            self.fc = ns.Linear(8, 8)
            self.ln = ns.LayerNorm(8)
            self.out = ns.Linear(8, 4)

        def forward(self, x):
            h = ns.functional.gelu(self.ln(self.fc(x)), approximate=True)
            return ns.functional.softmax(self.out(h), axis=-1)
    return Net()


def _pair():
    P.seed(0)
    pm = _net(nn)
    pm.eval()
    jm = jax_twin(lambda: _net(J.nn), pm)
    jm.eval()
    return pm, jm


def test_codecs_read_each_others_bytes(tmp_path):
    """Each side's file parses in the other and serializes back to the
    same bytes; the field values agree (producer, opset, io, ops)."""
    pm, jm = _pair()
    x = np.random.RandomState(0).rand(3, 8).astype(F32)
    pp = P.onnx.export(pm, str(tmp_path / "p"), input_spec=[P.to_tensor(x)])
    jp = J.onnx.export(jm, str(tmp_path / "j"), input_spec=[J.to_tensor(x)])
    pbytes, jbytes = open(pp, "rb").read(), open(jp, "rb").read()
    jm_of_p = jpb.ModelProto()
    jm_of_p.ParseFromString(pbytes)
    assert jm_of_p.SerializeToString() == pbytes
    pm_of_j = ppb.ModelProto()
    pm_of_j.ParseFromString(jbytes)
    assert pm_of_j.SerializeToString() == jbytes
    for m in (jm_of_p, pm_of_j):
        assert m.producer_name == "paddle_tpu"
        assert m.opset_import[0].version == 13 and m.ir_version == 8
        assert len(m.graph.input) == 1 and len(m.graph.output) == 1
        assert [d.dim_value for d in
                m.graph.input[0].type.tensor_type.shape.dim] == [3, 8]
    assert {n.op_type for n in jm_of_p.graph.node} >= {"MatMul", "Tanh",
                                                       "Exp", "Div"}


def test_every_field_kind_encodes_as_protobuf_does():
    def build(pb):
        m = pb.ModelProto()
        m.ir_version = 8
        m.producer_name = "paddle_tpu"
        m.model_version = -3
        op = m.opset_import.add()
        op.version = 13
        g = m.graph
        g.name = "g"
        n = g.node.add()
        n.input[:] = ["a", "b"]
        n.output[:] = ["c"]
        n.op_type = "Gemm"
        for name, kind, val in (("f", 1, 0.5), ("i", 2, -7),
                                ("s", 3, b"x\x00y"), ("ints", 7, [1, -2])):
            a = n.attribute.add()
            a.name, a.type = name, kind
            if kind == 7:
                a.ints[:] = val
            elif kind == 1:
                a.f = val
            elif kind == 2:
                a.i = val
            else:
                a.s = val
        a = n.attribute.add()
        a.name = "fl"
        a.floats[:] = [1.5, -2.25]
        a.strings[:] = [b"p", b"q"]
        a.t.name = "inner"
        a.t.dims[:] = [2]
        t = g.initializer.add()
        t.name = "w"
        t.dims[:] = [2, 3]
        t.data_type = 1
        t.raw_data = np.arange(6, dtype=F32).tobytes()
        vi = g.input.add()
        vi.name = "a"
        vi.type.tensor_type.elem_type = 1
        vi.type.tensor_type.shape.dim.add().dim_value = 4
        vi.type.tensor_type.shape.dim.add().dim_param = "batch"
        return m

    assert build(ppb).SerializeToString() == build(jpb).SerializeToString()
    back = ppb.ModelProto()
    back.ParseFromString(build(jpb).SerializeToString())
    assert back == build(ppb)
    assert back.model_version == -3
    assert list(back.graph.node[0].attribute[3].ints) == [1, -2]
    assert list(back.graph.node[0].attribute[4].floats) == [1.5, -2.25]


def test_port_runtime_equals_jax_runtime_on_a_jax_export(tmp_path):
    """Within 1e-6 (both are numpy over the same graph)."""
    _pm, jm = _pair()
    x = np.random.RandomState(1).rand(5, 8).astype(F32)
    path = J.onnx.export(jm, str(tmp_path / "j"), input_spec=[
        J.to_tensor(x)])
    got = prt.run(path, [x])[0]
    want = jrt.run(path, [x])[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_port_export_through_the_jax_runtime(tmp_path):
    """The port's file, read by the JAX runtime (protobuf), gives the
    JAX model's output on the same weights within 1e-5; the port's own
    runtime gives the same."""
    pm, jm = _pair()
    x = np.random.RandomState(2).rand(4, 8).astype(F32)
    path = P.onnx.export(pm, str(tmp_path / "p"),
                         input_spec=[P.to_tensor(x)])
    want = jax_forward(jm, x)
    np.testing.assert_allclose(jrt.run(path, [x])[0], want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(prt.run(path, [x])[0], want, rtol=1e-5,
                               atol=1e-6)


def test_conv_pool_model_exports_and_runs(tmp_path):
    """Conv, MaxPool and AveragePool (the port's additions to the JAX
    subset) with eval BatchNorm and ReLU6: the runtime's output within
    1e-5 of the eager model."""
    P.seed(0)
    m = nn.Sequential(nn.Conv2D(3, 4, 3, stride=2, padding=1),
                      nn.BatchNorm2D(4), nn.ReLU6(),
                      nn.MaxPool2D(3, 2, padding=1),
                      nn.Conv2D(4, 4, 3, padding=1, groups=2),
                      nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                      nn.Linear(4, 3))
    m.eval()
    x = np.random.RandomState(3).randn(2, 3, 16, 16).astype(F32)
    path = P.onnx.export(m, str(tmp_path / "cnn"),
                         input_spec=[P.to_tensor(x)])
    ops = {n.op_type for n in prt.load(path).graph.node}
    assert {"Conv", "MaxPool", "AveragePool"} <= ops
    np.testing.assert_allclose(prt.run(path, [x])[0],
                               m(P.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_unsupported_primitive_raises_loudly(tmp_path):
    class Weird(nn.Layer):
        def forward(self, x):
            return P.to_tensor(torch.fft.fft(x._data).real)

    with pytest.raises(NotImplementedError, match="primitive"):
        P.onnx.export(Weird(), str(tmp_path / "w"), input_spec=[
            P.to_tensor(np.zeros(8, F32))])
