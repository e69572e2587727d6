"""Parity of the port's math ops (`ops/quaternion.py`, `ops/affine2d.py`,
`ops/rotrepr.py`, `ops/rot6d.py`, `ops/mathfn.py`) with the JAX package's, on
random inputs made with numpy. Tolerance: f32, 1e-5 absolute and relative
(elementwise formulas in the same order; transcendental functions of two
libraries; the 3x3 products summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from neuralnet_tracker_traincode_tpu.ops import affine2d as JA, mathfn as JM, quaternion as JQ, rot6d as J6, rotrepr as JR
from neuralnet_tracker_traincode_torch.ops import affine2d as TA, mathfn as TM, quaternion as TQ, rot6d as T6, rotrepr as TR
from tests.torch_port_helpers import t

N = 64


def _quats(rng, n=N, unit=True):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True) if unit else q


def _rotmats(rng):
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(_quats(rng).astype(np.float64)).as_matrix().astype(np.float32)


def _check(out, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol, atol=tol)


_QUAT_CASES = {
    "mult": lambda m, r: m.mult(*_args(m, _quats(r, unit=False), _quats(r, unit=False))),
    "conjugate": lambda m, r: m.conjugate(*_args(m, _quats(r))),
    "rotate": lambda m, r: m.rotate(*_args(m, _quats(r, 8, unit=False)[:, None], r.randn(8, 5, 3).astype(np.float32))),
    "tomatrix": lambda m, r: m.tomatrix(*_args(m, _quats(r))),
    "from_matrix": lambda m, r: m.from_matrix(*_args(m, _rotmats(r))),
    "to_rotvec": lambda m, r: m.to_rotvec(*_args(m, _quats(r))),
    "rotation_delta": lambda m, r: m.rotation_delta(*_args(m, _quats(r), _quats(r))),
    "positivereal": lambda m, r: m.positivereal(*_args(m, _quats(r))),
    "normalized": lambda m, r: m.normalized(*_args(m, _quats(r, unit=False))),
    "distance": lambda m, r: m.distance(*_args(m, _quats(r), _quats(r))),
    "geodesicdistance": lambda m, r: m.geodesicdistance(*_args(m, _quats(r), _quats(r))),
}


def _args(module, *arrays):
    conv = jnp.asarray if module in (JQ, JM, JR, J6) else t
    return [conv(a) for a in arrays]


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(x, np.ndarray) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(_QUAT_CASES))
def test_quaternion_op_matches_jax(name):
    seed = sorted(_QUAT_CASES).index(name)
    ref = _QUAT_CASES[name](JQ, np.random.RandomState(seed))
    out = _QUAT_CASES[name](TQ, np.random.RandomState(seed))
    _check(_np(out), ref)


_MATH_CASES = {
    "smoothclip0": lambda m, r: m.smoothclip0(*_args(m, 3 * r.randn(N).astype(np.float32))),
    "inv_smoothclip0": lambda m, r: m.inv_smoothclip0(*_args(m, 0.05 + 3 * r.rand(N).astype(np.float32))),
    "matmul_hp": lambda m, r: m.matmul_hp(*_args(m, r.randn(8, 2, 3).astype(np.float32), r.randn(8, 3, 4).astype(np.float32))),
    "matvecmul": lambda m, r: m.matvecmul(*_args(m, r.randn(8, 2, 3).astype(np.float32), r.randn(8, 3).astype(np.float32))),
    "affinevecmul": lambda m, r: m.affinevecmul(*_args(m, r.randn(8, 2, 3).astype(np.float32), r.randn(8, 2).astype(np.float32))),
}


@pytest.mark.parametrize("name", sorted(_MATH_CASES))
def test_mathfn_op_matches_jax(name):
    seed = 100 + sorted(_MATH_CASES).index(name)
    ref = _MATH_CASES[name](JM, np.random.RandomState(seed))
    out = _MATH_CASES[name](TM, np.random.RandomState(seed))
    _check(_np(out), ref)


def _affine_inputs(seed):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(N, 2).astype(np.float32) * 10,
        rng.uniform(-3, 3, N).astype(np.float32),
        rng.uniform(0.5, 2, N).astype(np.float32),
    )


@pytest.mark.parametrize("with_angle", [True, False])
def test_affine2d_trs_compose_and_inverse_match_jax(with_angle):
    tr, ang, sc = _affine_inputs(0)
    tr2, ang2, sc2 = _affine_inputs(1)
    kw = lambda a, s, conv: dict(angles=conv(a) if with_angle else None, scales=conv(s))  # noqa: E731
    ja = JA.Affine2d.trs(jnp.asarray(tr), **kw(ang, sc, jnp.asarray))
    jb = JA.Affine2d.trs(jnp.asarray(tr2), **kw(ang2, sc2, jnp.asarray))
    ta = TA.Affine2d.trs(t(tr), **kw(ang, sc, t))
    tb = TA.Affine2d.trs(t(tr2), **kw(ang2, sc2, t))
    _check(ta.tensor().numpy(), ja.tensor())
    _check((ta @ tb).tensor().numpy(), (ja @ jb).tensor())
    _check(ta.inv().tensor().numpy(), ja.inv().tensor(), 1e-4)
    _check(ta.scales.numpy(), ja.scales)
    _check(ta.det.numpy(), ja.det)
    pts = np.random.RandomState(2).randn(N, 2).astype(np.float32)
    _check(TM.affinevecmul(ta.tensor(), t(pts)).numpy(), JM.affinevecmul(ja.tensor(), jnp.asarray(pts)), 1e-4)


def test_affine2d_range_remap_matches_jax():
    rng = np.random.RandomState(3)
    lo, hi = rng.rand(N, 2).astype(np.float32), 2 + rng.rand(N, 2).astype(np.float32)
    ref = JA.Affine2d.range_remap_2d(jnp.asarray(lo), jnp.asarray(hi), -1.0, 1.0).tensor()
    _check(TA.Affine2d.range_remap_2d(t(lo), t(hi), -1.0, 1.0).tensor().numpy(), ref)


_REPR_CASES = {
    "from_features": lambda m, r: m.QuatRepr.from_features(_args(m, r.randn(N, 4).astype(np.float32))[0])[0].value,
    "from_features_unnormalized": lambda m, r: m.QuatRepr.from_features(_args(m, r.randn(N, 4).astype(np.float32))[0])[1],
    "rotate_points": lambda m, r: m.QuatRepr(_args(m, _quats(r, 8))[0]).rotate_points(
        _args(m, r.randn(8, 68, 3).astype(np.float32))[0]),
    "mult": lambda m, r: m.QuatRepr(_args(m, _quats(r))[0]).mult(m.QuatRepr(_args(m, _quats(r))[0])).value,
    "make_rotate_x": lambda m, r: m.QuatRepr.make_rotate_x(_args(m, r.uniform(-3, 3, N).astype(np.float32))[0]).value,
}


@pytest.mark.parametrize("name", sorted(_REPR_CASES))
def test_quat_repr_matches_jax(name):
    seed = 200 + sorted(_REPR_CASES).index(name)
    ref = _REPR_CASES[name](JR, np.random.RandomState(seed))
    out = _REPR_CASES[name](TR, np.random.RandomState(seed))
    _check(_np(out), ref)


def _sixd(rng, n=N):
    """6D features: random, plus degenerate rows (x parallel to y, x zero,
    y zero, all zero) that must fall back to the identity."""
    z = rng.randn(n, 6).astype(np.float32)
    z[0, 3:] = 2.5 * z[0, :3]
    z[1, :3] = 0.0
    z[2, 3:] = 0.0
    z[3] = 0.0
    return z


_ROT6D_CASES = {
    "tomatrix": lambda m, r: m.tomatrix(*_args(m, _sixd(r))),
    "tomatrix_batch_dims": lambda m, r: m.tomatrix(*_args(m, _sixd(r).reshape(8, 8, 6))),
    "frommatrix": lambda m, r: m.frommatrix(*_args(m, _rotmats(r))),
    "orthonormality_loss": lambda m, r: m.orthonormality_loss(*_args(m, _sixd(r))),
    "rotation_distance_loss": lambda m, r: m.rotation_distance_loss(*_args(m, _rotmats(r), _rotmats(r))),
}


@pytest.mark.parametrize("name", sorted(_ROT6D_CASES))
def test_rot6d_op_matches_jax(name):
    seed = 300 + sorted(_ROT6D_CASES).index(name)
    ref = _ROT6D_CASES[name](J6, np.random.RandomState(seed))
    out = _ROT6D_CASES[name](T6, np.random.RandomState(seed))
    _check(_np(out), ref)


def test_rot6d_falls_back_to_identity_on_degenerate_input_only():
    m = T6.tomatrix(t(_sixd(np.random.RandomState(5))))
    eye = torch.eye(3)
    assert all(torch.equal(m[i], eye) for i in range(4))
    good = m[4:]
    assert not any(torch.equal(g, eye) for g in good)
    np.testing.assert_allclose((good @ good.transpose(1, 2)).numpy(), np.broadcast_to(np.eye(3), good.shape), atol=1e-5)


def test_rot6d_orthonormality_test_is_immune_to_autocast():
    """Under bf16 autocast a matmul-based M M^T would be rounded past the
    1e-3 threshold and turn good rotations into the identity."""
    z = t(_sixd(np.random.RandomState(6)))[4:]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        m = T6.tomatrix(z)
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), T6.tomatrix(z).numpy())
    assert not any(torch.equal(g, torch.eye(3)) for g in m)


_MAT33_CASES = {
    "from_6drepr_features": lambda m, r: m.Mat33Repr.from_6drepr_features(_args(m, _sixd(r))[0]).value,
    "rotate_points": lambda m, r: m.Mat33Repr(_args(m, _rotmats(r)[:8])[0]).rotate_points(
        _args(m, r.randn(8, 68, 3).astype(np.float32))[0]),
    "mult": lambda m, r: m.Mat33Repr(_args(m, _rotmats(r))[0]).mult(m.Mat33Repr(_args(m, _rotmats(r))[0])).value,
    "make_rotate_x": lambda m, r: m.Mat33Repr.make_rotate_x(_args(m, r.uniform(-3, 3, N).astype(np.float32))[0]).value,
    "as_quat": lambda m, r: m.Mat33Repr(_args(m, _rotmats(r))[0]).as_quat(),
}


@pytest.mark.parametrize("name", sorted(_MAT33_CASES))
def test_mat33_repr_matches_jax(name):
    seed = 400 + sorted(_MAT33_CASES).index(name)
    ref = _MAT33_CASES[name](JR, np.random.RandomState(seed))
    out = _MAT33_CASES[name](TR, np.random.RandomState(seed))
    _check(_np(out), ref)
