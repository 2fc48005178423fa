"""The port's sparse API and sparse 3D conv layers against the JAX
package, forward and gradient, on the CPU at tiny sizes: the same numpy
coordinates, values and (carried) weights go to both.  Coordinates and
structure must be equal; values and gradients within 1e-5 (the same f32
formulas, other summation orders)."""

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import sparse as jsparse
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.sparse import conv as jconv

import paddle_tpu_torch as paddle
from paddle_tpu_torch import sparse
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.sparse import conv as pconv

F32 = np.float32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")


def _np(t):
    return np.asarray(t.numpy())


def _pair(dense, grad=True, sparse_dim=None):
    """The same COO tensor in both packages -> (port, jax, port values,
    jax values)."""
    sd = sparse_dim or dense.ndim
    mask = (dense.reshape(dense.shape[:sd] + (-1,)) != 0).any(-1) \
        if sd < dense.ndim else dense != 0
    idx = np.stack(np.nonzero(mask))
    vals = dense[tuple(idx)]
    pv = Tensor(vals, stop_gradient=not grad)
    jv = JTensor(vals, stop_gradient=not grad)
    return (sparse.sparse_coo_tensor(idx, pv, dense.shape),
            jsparse.sparse_coo_tensor(idx, jv, dense.shape), pv, jv)


def _rand(rng, shape, density=0.4):
    return np.where(rng.rand(*shape) < density, rng.randn(*shape),
                    0.0).astype(F32)


def _same(p_sp, j_sp):
    assert p_sp.shape == j_sp.shape and p_sp.nnz == j_sp.nnz
    np.testing.assert_array_equal(_np(p_sp.indices()), _np(j_sp.indices()))
    np.testing.assert_allclose(_np(p_sp.values()), _np(j_sp.values()),
                               **TOL)
    np.testing.assert_allclose(_np(p_sp.to_dense()), _np(j_sp.to_dense()),
                               **TOL)


def test_coo_and_csr_construction():
    rng = np.random.RandomState(0)
    p, j, _, _ = _pair(_rand(rng, (4, 5)))
    _same(p, j)
    dense3 = _rand(rng, (2, 3, 4), 0.6)
    pc, jc = (paddle.to_tensor(dense3).to_sparse_csr(),
              jpaddle.to_tensor(dense3).to_sparse_csr())
    _same(pc, jc)
    assert pc.is_sparse_csr() and not pc.is_sparse_coo()
    np.testing.assert_array_equal(_np(pc.crows()), _np(jc.crows()))
    np.testing.assert_array_equal(_np(pc.cols()), _np(jc.cols()))
    rebuilt = sparse.sparse_csr_tensor(pc.crows(), pc.cols(), pc.values(),
                                       pc.shape)
    np.testing.assert_array_equal(_np(rebuilt.to_dense()), dense3)
    pcoo = paddle.to_tensor(dense3).to_sparse_coo(sparse_dim=2)
    jcoo = jpaddle.to_tensor(dense3).to_sparse_coo(sparse_dim=2)
    _same(pcoo, jcoo)


def test_coalesce_and_its_gradient():
    idx = np.array([[1, 0, 1, 2, 0], [2, 1, 2, 0, 1]])
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0], F32)
    pv, jv = Tensor(v, stop_gradient=False), JTensor(v, stop_gradient=False)
    pc = sparse.sparse_coo_tensor(idx, pv, (3, 3)).coalesce()
    jc = jsparse.sparse_coo_tensor(idx, jv, (3, 3)).coalesce()
    _same(pc, jc)
    cot = np.array([10.0, 100.0, 1000.0], F32)
    (pc.values() * Tensor(cot)).sum().backward()
    (jc.values() * JTensor(cot)).sum().backward()
    np.testing.assert_array_equal(_np(pv.grad), _np(jv.grad))


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide"])
def test_union_binaries(name):
    rng = np.random.RandomState(1)
    a, b = _rand(rng, (4, 5)), _rand(rng, (4, 5))
    pa, ja, pav, jav = _pair(a)
    pb, jb, pbv, jbv = _pair(b)
    po, jo = getattr(sparse, name)(pa, pb), getattr(jsparse, name)(ja, jb)
    np.testing.assert_array_equal(_np(po.indices()), _np(jo.indices()))
    finite = np.isfinite(_np(jo.values()))
    np.testing.assert_allclose(_np(po.values())[finite],
                               _np(jo.values())[finite], **TOL)
    if name != "divide":   # divide's union holds 0/0
        po.values().sum().backward()
        jo.values().sum().backward()
        np.testing.assert_allclose(_np(pav.grad), _np(jav.grad), **TOL)
        np.testing.assert_allclose(_np(pbv.grad), _np(jbv.grad), **TOL)


def test_sum_transpose_reshape_slice():
    rng = np.random.RandomState(2)
    d = _rand(rng, (3, 4, 5))
    p, j, pv, jv = _pair(d)
    for axis, keep in ((None, False), (0, False), (1, True), (2, False)):
        po, jo = (sparse.sum(p, axis=axis, keepdim=keep),
                  jsparse.sum(j, axis=axis, keepdim=keep))
        if axis is None:
            np.testing.assert_allclose(float(po), float(jo), **TOL)
        else:
            _same(po, jo)
    _same(sparse.transpose(p, [2, 0, 1]), jsparse.transpose(j, [2, 0, 1]))
    _same(sparse.reshape(p, [6, -1]), jsparse.reshape(j, [6, -1]))
    ps = sparse.slice(p, [0, 2], [1, -3], [3, 5])
    js = jsparse.slice(j, [0, 2], [1, -3], [3, 5])
    _same(ps, js)
    (ps.values() ** 2).sum().backward()
    (js.values() ** 2).sum().backward()
    np.testing.assert_allclose(_np(pv.grad), _np(jv.grad), **TOL)
    hyb = _rand(rng, (5, 3), 0.5)
    ph, jh, _, _ = _pair(hyb, grad=False, sparse_dim=1)
    _same(sparse.sum(ph, axis=1), jsparse.sum(jh, axis=1))


def test_products_and_their_gradients():
    rng = np.random.RandomState(3)
    a = _rand(rng, (5, 4), 0.5)
    dense_b = rng.randn(4, 3).astype(F32)
    p, j, pv, jv = _pair(a)
    pb, jb = (Tensor(dense_b, stop_gradient=False),
              JTensor(dense_b, stop_gradient=False))
    outs = []
    for mod, sp, b, lib in ((sparse, p, pb, paddle), (jsparse, j, jb,
                                                      jpaddle)):
        inp = lib.to_tensor(np.ones((5, 3), F32))
        mm = mod.matmul(sp, b)
        am = mod.addmm(inp, sp, b, beta=0.5, alpha=2.0)
        mv = mod.mv(sp, lib.to_tensor(dense_b[:, 0]))
        sm = mod.softmax(sp)
        (mm.sum() + (am * am).sum() + mv.sum()
         + (sm.values() * sm.values()).sum()).backward()
        outs.append([_np(mm), _np(am), _np(mv), _np(sm.values())])
    for x, y in zip(*outs):
        np.testing.assert_allclose(x, y, **TOL)
    np.testing.assert_allclose(_np(pv.grad), _np(jv.grad), **TOL)
    np.testing.assert_allclose(_np(pb.grad), _np(jb.grad), **TOL)
    # dense @ sparse and masked_matmul
    x = rng.randn(3, 5).astype(F32)
    pm, jm = (sparse.matmul(paddle.to_tensor(x), p),
              jsparse.matmul(jpaddle.to_tensor(x), j))
    np.testing.assert_allclose(_np(pm), _np(jm), **TOL)
    mask = _rand(rng, (3, 3), 0.5)
    pmask, jmask, _, _ = _pair(mask, grad=False)
    ya = rng.randn(3, 4).astype(F32)
    pa, ja = (Tensor(ya, stop_gradient=False),
              JTensor(ya, stop_gradient=False))
    pmm = sparse.masked_matmul(pa, paddle.to_tensor(dense_b), pmask)
    jmm = jsparse.masked_matmul(ja, jpaddle.to_tensor(dense_b), jmask)
    _same(pmm, jmm)
    pmm.values().sum().backward()
    jmm.values().sum().backward()
    np.testing.assert_allclose(_np(pa.grad), _np(ja.grad), **TOL)


def test_fused_attention_and_batch_norm():
    rng = np.random.RandomState(4)
    b, h, l, d = 1, 2, 6, 4
    q, k, v = (rng.randn(b, h, l, d).astype(F32) for _ in range(3))
    mask = (rng.rand(b * h, l, l) < 0.5).astype(F32)
    mask[:, np.arange(l), np.arange(l)] = 1.0
    pmask, jmask, _, _ = _pair(mask, grad=False)
    kp = np.ones((b, l), F32)
    kp[0, -1] = 0
    pq = Tensor(q, stop_gradient=False)
    jq = JTensor(q, stop_gradient=False)
    po = sparse.nn.functional.attention(pq, Tensor(k), Tensor(v), pmask,
                                        key_padding_mask=Tensor(kp))
    jo = jsparse.nn.functional.attention(jq, JTensor(k), JTensor(v), jmask,
                                         key_padding_mask=JTensor(kp))
    np.testing.assert_allclose(_np(po), _np(jo), **TOL)
    po.sum().backward()
    jo.sum().backward()
    np.testing.assert_allclose(_np(pq.grad), _np(jq.grad), **TOL)
    vals = (rng.randn(7, 3) * 2 + 1).astype(F32)
    idx = np.stack([np.zeros(7, int), rng.randint(0, 4, 7),
                    rng.randint(0, 4, 7), np.arange(7) % 4])
    pbn, jbn = sparse.nn.BatchNorm(3), jsparse.nn.BatchNorm(3)
    pout = pbn(sparse.sparse_coo_tensor(idx, Tensor(vals), (1, 4, 4, 4, 3)))
    jout = jbn(jsparse.sparse_coo_tensor(idx, JTensor(vals),
                                         (1, 4, 4, 4, 3)))
    np.testing.assert_allclose(_np(pout.values()), _np(jout.values()),
                               **TOL)


def _voxels(rng, n, grid=(7, 9, 8), batch=2):
    c = np.stack([rng.randint(0, batch, n), rng.randint(0, grid[0], n),
                  rng.randint(0, grid[1], n), rng.randint(0, grid[2], n)],
                 1)
    return np.unique(c, axis=0)


@pytest.mark.parametrize("subm,ks,st,pad", [
    (True, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (False, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (False, (2, 3, 1), (1, 2, 1), (0, 1, 0)),
], ids=["subm", "strided", "uneven"])
def test_conv_rulebook_equals_the_reference(subm, ks, st, pad):
    """The vectorised rulebook against the JAX module's dictionary loops,
    duplicate input sites included (the last one wins)."""
    rng = np.random.RandomState(5)
    c = _voxels(rng, 80)
    c = np.concatenate([c, c[:4]])
    want = jconv._rulebook(c, ks, st, pad, subm, (7, 9, 8))
    got = pconv._rulebook(c, ks, st, pad, subm, (7, 9, 8))
    np.testing.assert_array_equal(got[0], want[0])
    for (gi, go), (wi, wo) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(go, wo)


@pytest.fixture
def jitted_jax_conv(monkeypatch):
    """The JAX conv's gather-matmul-scatter body as one jitted call: run
    op by op, each offset's differently sized gather compiles on its own
    (about 380 XLA compiles, 30 s, for this test).  The same function of
    the same values; only how JAX runs it changes."""
    import jax

    from paddle_tpu.ops import dispatch

    eager = dispatch.apply_op

    def apply_op(name, fn, args, kwargs, cacheable=True):
        if name == "sparse_conv3d":
            fn = jax.jit(fn)
        return eager(name, fn, args, kwargs, cacheable=cacheable)

    monkeypatch.setattr(dispatch, "apply_op", apply_op)


def test_sparse_conv_chain_against_the_reference(jitted_jax_conv):
    """SubmConv3D -> Conv3D(stride 2) -> MaxPool3D, the smoke's middle
    stage at a tiny grid less its second SubmConv3D (the same layer
    again): weights carried from the JAX layers by ``set_state_dict``
    (JAX keys, numpy values); coordinates equal; values and every
    gradient within 1e-5."""
    rng = np.random.RandomState(6)
    coords = _voxels(rng, 120)
    vals = rng.randn(len(coords), 4).astype(F32)
    shape = (2, 7, 9, 8, 4)
    jpaddle.seed(0)
    jl = [jsparse.nn.SubmConv3D(4, 8, 3, padding=1),
          jsparse.nn.Conv3D(8, 6, 3, stride=2, padding=1)]
    pl = [sparse.nn.SubmConv3D(4, 8, 3, padding=1),
          sparse.nn.Conv3D(8, 6, 3, stride=2, padding=1)]
    for p, j in zip(pl, jl):
        sd = {k: v.numpy() for k, v in j.state_dict().items()}
        sd["bias"] = (rng.randn(*sd["bias"].shape) * 0.1).astype(F32)
        p.set_state_dict(sd)
        j.set_state_dict({k: jpaddle.to_tensor(v) for k, v in sd.items()})
    pv, jv = (Tensor(vals, stop_gradient=False),
              JTensor(vals, stop_gradient=False))
    px = sparse.sparse_coo_tensor(coords.T, pv, shape)
    jx = jsparse.sparse_coo_tensor(coords.T, jv, shape)
    for p, j in zip(pl, jl):
        px, jx = sparse.relu(p(px)), jsparse.relu(j(jx))
        _same(px, jx)
    px, jx = sparse.nn.MaxPool3D(2)(px), jsparse.nn.MaxPool3D(2)(jx)
    _same(px, jx)
    (px.values() ** 2).sum().backward()
    (jx.values() ** 2).sum().backward()
    np.testing.assert_allclose(_np(pv.grad), _np(jv.grad), **TOL)
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(_np(p.weight.grad), _np(j.weight.grad),
                                   **TOL)
        np.testing.assert_allclose(_np(p.bias.grad), _np(j.bias.grad),
                                   **TOL)


def test_pool_with_overlapping_windows_and_empty_input():
    rng = np.random.RandomState(7)
    coords = _voxels(rng, 60)
    vals = rng.randn(len(coords), 3).astype(F32)
    shape = (2, 7, 9, 8, 3)
    for ks, st, pad in ((3, 2, 1), (2, 1, 0)):
        po = sparse.nn.MaxPool3D(ks, stride=st, padding=pad)(
            sparse.sparse_coo_tensor(coords.T, Tensor(vals), shape))
        jo = jsparse.nn.MaxPool3D(ks, stride=st, padding=pad)(
            jsparse.sparse_coo_tensor(coords.T, JTensor(vals), shape))
        _same(po, jo)
    empty = sparse.sparse_coo_tensor(np.zeros((4, 0), np.int64),
                                     Tensor(np.zeros((0, 3), F32)), shape)
    out = sparse.nn.MaxPool3D(2)(empty)
    assert out.nnz == 0 and out.shape == [2, 3, 4, 4, 3]
