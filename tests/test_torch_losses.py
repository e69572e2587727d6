"""Parity of the port's losses off the flagship, its shape prior and its loss
setup with the JAX package's, on the same predictions and labels (made with
numpy from a seed).

Tolerance: f32, 1e-5 relative and 1e-6 absolute per sample (the same
elementwise formulas; logsumexp, log and atan2 of two libraries). The prior's
npz must equal the JAX package's h5 array for array and dtype for dtype.
`setup_losses` is held against the training CLI's for all 32 combinations
of its five loss options: the same terms in the same order, the same weight
matrices at epochs across the NLL ramp-up, and the same loss and per-term
values on the same predictions for a batch that holds every tag.
"""

import itertools
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag
from neuralnet_tracker_traincode_tpu.losses import losses as JL, nll as JNLL
from neuralnet_tracker_traincode_tpu.models.components import GaussianMixture as JGMM
from neuralnet_tracker_traincode_tpu.ops import rotrepr as JR
from neuralnet_tracker_traincode_torch.data.fields import Tag as TTag
from neuralnet_tracker_traincode_torch.losses import losses as TL, nll as TNLL
from neuralnet_tracker_traincode_torch.models.components import SHAPEPARAMS_GMM_NPZ, GaussianMixture as TGMM
from neuralnet_tracker_traincode_torch.ops import rotrepr as TR
from neuralnet_tracker_traincode_torch.train.run import LossOptions, setup_losses
from tests.torch_port_helpers import cli_setup_losses, normalized_labels, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GMM_H5 = os.path.join(ROOT, "neuralnet_tracker_traincode_tpu", "facemodel", "assets", "shapeparams_gmm.h5")
B = 8


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out.detach()), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _tril(rng, *prefix):
    m = np.tril(rng.randn(*prefix, 3, 3) * 0.2).astype(np.float32)
    i = np.arange(3)
    m[..., i, i] = rng.uniform(0.1, 1.0, prefix + (3,))
    return m


def _predictions(rng, n=B):
    """Raw head outputs of both kinds: quaternion and 6D rotation."""
    q = rng.randn(n, 4).astype(np.float32)
    six = rng.randn(n, 6).astype(np.float32)
    return {
        "quat_unnormalized": q,
        "quat": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "sixd": six,
        "coord": rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        "coord_scales": _tril(rng, n),
        "coord_scales_diag": rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32),  # CoordPoseNLLLoss's
        "pose_scales_tril": _tril(rng, n),
        "roi": rng.uniform(-1, 1, (n, 4)).astype(np.float32),
        "roi_scales": rng.uniform(0.05, 1.0, (n, 4)).astype(np.float32),
        "pt3d_68": (0.5 * rng.randn(n, 68, 3)).astype(np.float32),
        "pt3d_68_scales": rng.uniform(0.05, 1.0, (n, 68, 3)).astype(np.float32),
        "shapeparam": rng.randn(n, 50).astype(np.float32),
        "shapeparam_scales": rng.uniform(0.05, 1.0, (n, 50)).astype(np.float32),
    }


def _pred_dict(raw, sixd: bool, jax_side: bool, diag_coord_scales: bool = False):
    conv = jnp.asarray if jax_side else t
    R = JR if jax_side else TR
    out = {k: conv(raw[k]) for k in ("coord", "coord_scales", "pose_scales_tril", "roi", "roi_scales", "pt3d_68",
                                      "pt3d_68_scales", "shapeparam", "shapeparam_scales")}
    if diag_coord_scales:
        out["coord_scales"] = conv(raw["coord_scales_diag"])
    if sixd:
        out["unnormalized_6drepr"] = conv(raw["sixd"])
        out["rot"] = R.Mat33Repr.from_6drepr_features(conv(raw["sixd"]))
    else:
        out["unnormalized_quat"] = conv(raw["quat_unnormalized"])
        out["rot"] = R.QuatRepr(conv(raw["quat"]))
    return out


_LOSSES = {
    "QuatPoseLoss(smooth_geodesic)": (False, lambda L, N: L.QuatPoseLoss("smooth_geodesic")),
    "QuatPoseLoss(approx_distance)": (False, lambda L, N: L.QuatPoseLoss("approx_distance")),
    "Rot6dReprLoss": (True, lambda L, N: L.Rot6dReprLoss()),
    "Rot6dNormalizationSoftConstraint": (True, lambda L, N: L.Rot6dNormalizationSoftConstraint()),
    "ShapeParameterLoss": (False, lambda L, N: L.ShapeParameterLoss()),
    "ShapePlausibilityLoss": (False, lambda L, N: (
        L.ShapePlausibilityLoss.from_hdf5(GMM_H5) if L is JL else L.ShapePlausibilityLoss.from_npz())),
    "QuatPoseNLLLoss(Mat33Repr)": (True, lambda L, N: N.QuatPoseNLLLoss()),
    "CorrelatedCoordPoseNLLLoss": (False, lambda L, N: N.CorrelatedCoordPoseNLLLoss()),
}
for _dist in ("gaussian", "laplace"):
    _LOSSES.update({
        f"CoordPoseNLLLoss({_dist})": (False, lambda L, N, d=_dist: N.CoordPoseNLLLoss(0.7, 0.3, distribution=d)),
        f"BoxNLLLoss({_dist})": (False, lambda L, N, d=_dist: N.BoxNLLLoss(distribution=d)),
        f"Points3dNLLLoss(3, {_dist})": (False, lambda L, N, d=_dist: N.Points3dNLLLoss(0.8, 0.0, distribution=d)),
        f"Points3dNLLLoss(2, {_dist})": (False, lambda L, N, d=_dist: N.Points3dNLLLoss(
            0.8, 0.0, pointdimension=2, distribution=d)),
        f"ShapeParamsNLLLoss({_dist})": (False, lambda L, N, d=_dist: N.ShapeParamsNLLLoss(distribution=d)),
    })


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_matches_jax(name):
    sixd, make = _LOSSES[name]
    rng = np.random.RandomState(sorted(_LOSSES).index(name))
    raw, labels = _predictions(rng), normalized_labels(rng, B)
    diag = name.startswith("CoordPoseNLLLoss")
    ref = make(JL, JNLL)(_pred_dict(raw, sixd, True, diag), {k: jnp.asarray(v) for k, v in labels.items()})
    out = make(TL, TNLL)(_pred_dict(raw, sixd, False, diag), {k: t(v) for k, v in labels.items()})
    assert out.shape == (B,) and out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out, ref)


@pytest.mark.parametrize("kind", ["gaussian", "laplace"])
def test_log_prob_matches_jax(kind):
    rng = np.random.RandomState(7)
    x, loc = rng.randn(3, 5, 4).astype(np.float32), rng.randn(3, 5, 4).astype(np.float32)
    scale = rng.uniform(0.05, 2.0, (3, 5, 4)).astype(np.float32)
    _close(TNLL._LOG_PROB[kind](t(x), t(loc), t(scale)), JNLL._LOG_PROB[kind](*map(jnp.asarray, (x, loc, scale))))


@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5])
def test_fill_triangular_matrix_matches_jax(dim):
    """The lower-triangular fill at every dim: stack-based at 3, index
    assignment otherwise; bit-equal values, and the gradient reaches each
    element of z once."""
    from neuralnet_tracker_traincode_tpu.models import nll as JM
    from neuralnet_tracker_traincode_torch.models import nll as TM

    z = np.random.RandomState(dim).randn(2, 3, dim * (dim + 1) // 2).astype(np.float32)
    ref = np.asarray(JM.fill_triangular_matrix(dim, jnp.asarray(z)))
    zt = t(z).requires_grad_(True)
    out = TM.fill_triangular_matrix(dim, zt)
    assert out.shape == (2, 3, dim, dim)
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    out.sum().backward()
    np.testing.assert_array_equal(zt.grad.numpy(), np.ones_like(z))


def test_shape_prior_npz_equals_the_h5_asset():
    with h5py.File(GMM_H5, "r") as h5, np.load(SHAPEPARAMS_GMM_NPZ, allow_pickle=False) as npz:
        assert str(npz["covariance_type"]) == h5.attrs["covariance_type"] == "diag"
        assert set(npz.files) == {"covariance_type", "weights", "means", "cov"}
        for k in ("weights", "means", "cov"):
            assert npz[k].dtype == h5[k].dtype and npz[k].shape == h5[k].shape, k
            np.testing.assert_array_equal(npz[k], h5[k][...], err_msg=k)
    assert (TGMM.from_npz().n_components, TGMM.from_npz().means.shape) == (2, (2, 50))


def test_gmm_log_likelihood_matches_jax():
    """Near the means and far out (where logsumexp picks one component)."""
    jg, tg = JGMM.from_hdf5(GMM_H5), TGMM.from_npz()
    rng = np.random.RandomState(8)
    x = np.concatenate([jg.means + 0.3 * rng.randn(2, 50), 4.0 * rng.randn(6, 50)]).astype(np.float32)
    _close(tg(t(x)), jg(jnp.asarray(x)))
    _close(tg(t(x.reshape(2, 4, 50))), jg(jnp.asarray(x.reshape(2, 4, 50))))


_TAGS = ("ONLY_POSE", "POSE_WITH_LMKS_NO_SHAPE_PARAMS", "POSE_WITH_LANDMARKS", "POSE_WITH_LANDMARKS_3D_AND_2D",
         "ONLY_LANDMARKS", "ONLY_LANDMARKS_25D", "ONLY_LANDMARKS_2D")
_OPTIONS = ("with_nll_loss", "rampup_nll_losses", "with_roi_train", "with_pointhead", "enable_6drot")


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=5)),
                         ids=lambda f: "".join("1" if v else "0" for v in f))
def test_setup_losses_matches_the_training_cli(flags):
    opts = LossOptions(epochs=20, **dict(zip(_OPTIONS, flags)))
    jc = cli_setup_losses()(opts, [getattr(JTag, n) for n in _TAGS])
    tc = setup_losses(opts, [getattr(TTag, n) for n in _TAGS])
    assert [x.name for x in tc.terms] == [x.name for x in jc.terms]
    for epoch in (0, 2, 3, 19):
        np.testing.assert_array_equal(tc.weight_matrix(epoch), jc.weight_matrix(epoch))
    rng = np.random.RandomState(sum(v << i for i, v in enumerate(flags)))
    n = 2 * len(_TAGS)
    raw, labels = _predictions(rng, n), normalized_labels(rng, n)
    tag = np.arange(n, dtype=np.int32) % len(_TAGS)
    weight = rng.uniform(0.5, 1.5, n).astype(np.float32)
    W = jc.weight_matrix(3)
    jloss, jby = jc(_pred_dict(raw, opts.enable_6drot, True), {k: jnp.asarray(v) for k, v in labels.items()},
                    jnp.asarray(tag), jnp.asarray(W), dataset_weight=jnp.asarray(weight))
    tloss, tby = tc(_pred_dict(raw, opts.enable_6drot, False), {k: t(v) for k, v in labels.items()},
                    t(tag), t(W), dataset_weight=t(weight))
    _close(tloss, jloss)
    assert set(tby) == set(jby)
    for k in jby:
        _close(tby[k][0], jby[k][0])
        _close(tby[k][1], jby[k][1])
