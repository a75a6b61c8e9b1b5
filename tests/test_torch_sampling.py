"""The port's sampling and grouping ops (``epcnet_torch/ops/sampling.py``)
against the JAX package's (``epcnet_tpu/ops/sampling.py``) on seeded numpy
inputs: ids exactly, values within 1e-6, and the gradients of
``gather_point``, ``group_point`` and ``three_interpolate`` against
``jax.grad`` within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu.ops import sampling as jsamp

from epcnet_torch.ops import sampling as tsamp

TOL = 1e-6


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _cloud(seed, b, n, grid=None):
    x = np.random.default_rng(seed).uniform(-1, 1, (b, n, 3)).astype(np.float32)
    return np.round(x * grid) / grid if grid else x


@pytest.mark.parametrize("b,n,npoint,grid", [
    (2, 512, 64, None),
    (1, 300, 300, None),  # every point
    (2, 256, 40, 3),  # a coarse grid: equal distances, the first maximum wins
    (3, 1, 1, None),
])
def test_farthest_point_sample_matches(b, n, npoint, grid):
    x = _cloud(n + npoint, b, n, grid)
    got = tsamp.farthest_point_sample(_t(x), npoint)
    want = np.asarray(jsamp.farthest_point_sample(jnp.asarray(x), npoint))
    assert got.dtype == torch.int32 and got.shape == (b, npoint)
    np.testing.assert_array_equal(got.numpy(), want)


def test_farthest_point_sample_leading_axes():
    x = _cloud(5, 6, 128).reshape(2, 3, 128, 3)
    got = tsamp.farthest_point_sample(_t(x), 16)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsamp.farthest_point_sample(jnp.asarray(x), 16)))


def test_gather_point_and_gradient():
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((2, 100, 5)).astype(np.float32)
    idx = rng.integers(0, 100, (2, 37)).astype(np.int32)
    idx[0, :5] = 7  # repeated ids: the gradient sums
    w = rng.standard_normal((2, 37, 5)).astype(np.float32)
    p = _t(pts, grad=True)
    out = tsamp.gather_point(p, _t(idx))
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jsamp.gather_point(jnp.asarray(pts), jnp.asarray(idx))))
    (out * _t(w)).sum().backward()
    jg = jax.grad(lambda q: jnp.sum(jsamp.gather_point(q, jnp.asarray(idx)) * w))(
        jnp.asarray(pts))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=0, atol=TOL)


def test_prob_sample_matches():
    rng = np.random.default_rng(2)
    p = rng.random((3, 50)).astype(np.float32)
    p[1, 10:20] = 0.0  # zero-probability entries are never drawn
    p /= p.sum(-1, keepdims=True)
    r = rng.random((3, 200)).astype(np.float32)
    r[0, :3] = [0.0, 1.0, 1.5]  # the ends, and past the total mass
    got = tsamp.prob_sample(_t(p), _t(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsamp.prob_sample(jnp.asarray(p), jnp.asarray(r))))
    edge = tsamp.prob_sample(_t(np.float32([[0.0, 0.5, 0.0, 0.5]])),
                             _t(np.float32([[0.01, 0.49, 0.51, 0.999, 1.5]])))
    np.testing.assert_array_equal(edge.numpy()[0], [1, 1, 3, 3, 3])


@pytest.mark.parametrize("radius,nsample", [(0.3, 16), (0.05, 8), (5.0, 4), (0.5, 300)])
def test_ball_query_matches(radius, nsample):
    xyz = _cloud(3, 2, 256)
    new = xyz[:, ::4].copy()
    new[1, 0] = 9.0  # a centre with no point in its ball
    got = tsamp.ball_query(radius, nsample, _t(xyz), _t(new))
    want = np.asarray(jsamp.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(new)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_point_and_gradient():
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((2, 60, 7)).astype(np.float32)
    idx = rng.integers(0, 60, (2, 11, 9)).astype(np.int32)
    w = rng.standard_normal((2, 11, 9, 7)).astype(np.float32)
    p = _t(pts, grad=True)
    out = tsamp.group_point(p, _t(idx))
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jsamp.group_point(jnp.asarray(pts), jnp.asarray(idx))))
    (out * _t(w)).sum().backward()
    jg = jax.grad(lambda q: jnp.sum(jsamp.group_point(q, jnp.asarray(idx)) * w))(
        jnp.asarray(pts))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=0, atol=TOL)


@pytest.mark.parametrize("grid", [None, 4])
def test_three_nn_matches(grid):
    unknown = _cloud(5, 2, 200, grid)
    known = _cloud(6, 2, 50, grid)
    d, idx = tsamp.three_nn(_t(unknown), _t(known))
    jd, jidx = jsamp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))  # ties: lowest index
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=TOL)


def test_three_interpolate_and_gradient():
    rng = np.random.default_rng(7)
    unknown, known = _cloud(8, 2, 120), _cloud(9, 2, 40)
    feats = rng.standard_normal((2, 40, 6)).astype(np.float32)
    w = rng.standard_normal((2, 120, 6)).astype(np.float32)
    d, idx = tsamp.three_nn(_t(unknown), _t(known))
    f = _t(feats, grad=True)
    dd = d.clone().requires_grad_(True)
    out = tsamp.three_interpolate(f, idx, dd)
    jd, jidx = jsamp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    want = jsamp.three_interpolate(jnp.asarray(feats), jidx, jd)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    (out * _t(w)).sum().backward()
    jgf, jgd = jax.grad(lambda a, b: jnp.sum(jsamp.three_interpolate(a, jidx, b) * w),
                        argnums=(0, 1))(jnp.asarray(feats), jd)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgf), rtol=0, atol=TOL)
    # d(out)/d(dists) scales as 1/d^2: held relative to its size
    np.testing.assert_allclose(dd.grad.numpy(), np.asarray(jgd), rtol=1e-4,
                               atol=TOL * float(np.abs(np.asarray(jgd)).max()))
    # at the known points themselves the interpolation returns the features
    d0, i0 = tsamp.three_nn(_t(known), _t(known))
    np.testing.assert_allclose(tsamp.three_interpolate(_t(feats), i0, d0).numpy(), feats,
                               atol=1e-4)
