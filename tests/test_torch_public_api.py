"""The JAX package's last public functions and classes without a counterpart
until now, held against the JAX functions on the CPU on inputs made from a
numpy seed.

Tolerances:
 - `from_rotvec`, `slerp`: 1e-6 absolute on unit quaternions (f32 sin, cos,
   atan2 and norms in another library; a few ulp). The `eps` branch: a zero
   rotation vector gives exactly (0, 0, 0, 1), and slerp between equal and
   between antipodal quaternions (the same rotation) gives back `p` within
   1e-6 at every t.
 - `sqrclip0`, `inv_sqrclip0`: 1e-6 relative + 1e-7 absolute.
 - `chain_gmm`, `roi_normalizing_transform`: 1e-6 relative + 1e-6 absolute
   (f32 matrix products of entries up to ~10).
 - `concatenated_lossvals_by_name`, `compute_loss_of_batches`: 1e-6
   relative (sums of a few f32 values).
 - `focus_roi_batch`: the image within 1e-3 gray (smooth sources, as in
   `test_torch_eval_crop.py`, which says why), every label and the
   backtransform within 1e-4 absolute + 1e-5 relative (coordinates up to
   ~130 px).
 - `random_flip_rot90_transform` with its draws injected, and `apply_fliprot`:
   exact (axis-aligned maps and permutations).
 - `FeaturesAsDiagonalScale` with the JAX weights carried through
   `models/weights.py`: 1e-6 relative + 1e-7 absolute; the weights back
   bit-equal. `inv_make_positive`: 1e-6.
 - The 22 named landmark groups: equal.

The file takes about 10 s alone on one CPU process, most of it JAX's first
compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation import geometric as JG
from neuralnet_tracker_traincode_tpu.augmentation import warp_fast as JWF
from neuralnet_tracker_traincode_tpu.data.batch import Batch as JBatch, Metadata as JMetadata
from neuralnet_tracker_traincode_tpu.data.fields import FieldCategory as JFC
from neuralnet_tracker_traincode_tpu.facemodel import keypoints68 as JK
from neuralnet_tracker_traincode_tpu.losses import criterion as JC
from neuralnet_tracker_traincode_tpu.models import nll as JNLL
from neuralnet_tracker_traincode_tpu.ops import affine2d as JA
from neuralnet_tracker_traincode_tpu.ops import mathfn as JM
from neuralnet_tracker_traincode_tpu.ops import quaternion as JQ
from neuralnet_tracker_traincode_torch.augmentation import geometric as TG
from neuralnet_tracker_traincode_torch.augmentation import warp_fast as TWF
from neuralnet_tracker_traincode_torch.data.batch import Batch, Metadata
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory
from neuralnet_tracker_traincode_torch.facemodel import keypoints68 as TK
from neuralnet_tracker_traincode_torch.losses import criterion as TC
from neuralnet_tracker_traincode_torch.models import nll as TNLL
from neuralnet_tracker_traincode_torch.models.weights import diagonal_scale_params_to_jax, diagonal_scale_state_dict_from_jax
from neuralnet_tracker_traincode_torch.ops import affine2d as TA
from neuralnet_tracker_traincode_torch.ops import mathfn as TM
from neuralnet_tracker_traincode_torch.ops import quaternion as TQ
from neuralnet_tracker_traincode_torch.train.loop import label_parameters
from tests.torch_port_helpers import t


@pytest.fixture
def rng():
    return np.random.RandomState(1717)


def _unit_quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---- ops ------------------------------------------------------------------------------

def test_from_rotvec_matches_jax_and_is_exact_at_zero(rng):
    r = (rng.randn(64, 3) * rng.uniform(0.0, 3.0, (64, 1))).astype(np.float32)
    r[0] = 0.0
    r[1] = [1e-8, 0.0, 0.0]  # below eps: the axis collapses, as in the JAX function
    out = TQ.from_rotvec(t(r)).numpy()
    np.testing.assert_allclose(out, np.asarray(JQ.from_rotvec(jnp.asarray(r))), rtol=0, atol=1e-6)
    assert out[0].tolist() == [0.0, 0.0, 0.0, 1.0]
    np.testing.assert_allclose(np.linalg.norm(out[2:], axis=-1), 1.0, atol=1e-6)
    # the inverse of to_rotvec away from pi (to_rotvec takes the positive real part)
    q = TQ.positivereal(t(_unit_quats(rng, 32)))
    np.testing.assert_allclose(TQ.from_rotvec(TQ.to_rotvec(q)).numpy(), q.numpy(), atol=1e-6)


@pytest.mark.parametrize("t_kind", ["float", "tensor"])
def test_slerp_matches_jax(rng, t_kind):
    p, q = _unit_quats(rng, 48), _unit_quats(rng, 48)
    if t_kind == "float":
        tt, jt = 0.3, 0.3
    else:
        tt_np = rng.uniform(-0.5, 1.5, (48, 1)).astype(np.float32)
        tt, jt = t(tt_np), jnp.asarray(tt_np)
    out = TQ.slerp(t(p), t(q), tt).numpy()
    np.testing.assert_allclose(out, np.asarray(JQ.slerp(jnp.asarray(p), jnp.asarray(q), jt)), rtol=0, atol=1e-6)
    # the ends: p at t = 0, q (up to sign) at t = 1
    np.testing.assert_allclose(TQ.slerp(t(p), t(q), 0.0).numpy(), p, atol=1e-6)
    ends = TQ.slerp(t(p), t(q), 1.0).numpy()
    np.testing.assert_allclose(np.abs(np.sum(ends * q, axis=-1)), 1.0, atol=1e-6)


def test_slerp_eps_branch_at_equal_and_antipodal_inputs(rng):
    """`p` and `q` = `p` or `-p` are the same rotation: the delta is a zero
    rotation vector, `from_rotvec` takes its `eps` branch and every t gives
    `p` back, in both packages."""
    p = _unit_quats(rng, 8)
    for q in (p, -p):
        for tt in (0.0, 0.25, 1.0, 2.0):
            out = TQ.slerp(t(p), t(q), tt).numpy()
            np.testing.assert_allclose(out, p, atol=1e-6)
            np.testing.assert_allclose(out, np.asarray(JQ.slerp(jnp.asarray(p), jnp.asarray(q), tt)), atol=1e-6)


@pytest.mark.parametrize("beta", [0.5, 2.0])
def test_sqrclip0_and_its_inverse_match_jax(rng, beta):
    x = np.concatenate([rng.uniform(-3, 3, 200), [-beta / 2, 0.0, beta / 2, beta, -10.0]]).astype(np.float32)
    y = TM.sqrclip0(t(x), beta).numpy()
    np.testing.assert_allclose(y, np.asarray(JM.sqrclip0(jnp.asarray(x), beta)), rtol=1e-6, atol=1e-7)
    assert (y >= 0).all()
    yy = np.concatenate([y, [0.0, beta / 2, 3.0]]).astype(np.float32)
    inv = TM.inv_sqrclip0(t(yy), beta).numpy()
    np.testing.assert_allclose(inv, np.asarray(JM.inv_sqrclip0(jnp.asarray(yy), beta)), rtol=1e-6, atol=1e-7)
    above = x > -beta / 2  # where sqrclip0 is invertible
    np.testing.assert_allclose(inv[:len(x)][above], x[above], rtol=1e-4, atol=1e-4)


def test_chain_gmm_matches_jax(rng):
    ms = [rng.randn(5, 3, 3).astype(np.float32) for _ in range(3)]
    out = TM.chain_gmm(*[t(m) for m in ms]).numpy()
    np.testing.assert_allclose(out, np.asarray(JM.chain_gmm(*[jnp.asarray(m) for m in ms])), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TM.chain_gmm(t(ms[0])).numpy(), ms[0])


def test_roi_normalizing_transform_matches_jax(rng):
    lo = rng.uniform(-20, 100, (7, 2))
    roi = np.concatenate([lo, lo + rng.uniform(5, 80, (7, 2))], -1).astype(np.float32)
    out = TA.roi_normalizing_transform(t(roi))
    np.testing.assert_allclose(out.tensor().numpy(), np.asarray(JA.roi_normalizing_transform(jnp.asarray(roi)).tensor()),
                               rtol=1e-6, atol=1e-6)
    corners = out.tensor()[:, :, :2] @ t(roi).reshape(7, 2, 2).transpose(1, 2) + out.tensor()[:, :, 2:]
    np.testing.assert_allclose(corners.numpy(), np.broadcast_to([[-1.0, 1.0], [-1.0, 1.0]], (7, 2, 2)), atol=1e-5)


# ---- the criterion on per-tag sub-batches ------------------------------------------------

def test_concatenated_lossvals_by_name_matches_jax(rng):
    vals = [(rng.rand(2), 1.0, "a"), (rng.rand(3), 2.0, "a"), (rng.rand(2), rng.rand(2), "b"), (rng.rand(), 0.5, "c")]
    jout = JC.concatenated_lossvals_by_name(
        [JC.LossVal(jnp.asarray(v, jnp.float32), w if np.isscalar(w) else jnp.asarray(w, jnp.float32), n)
         for v, w, n in vals])
    tout = TC.concatenated_lossvals_by_name(
        [TC.LossVal(torch.tensor(v, dtype=torch.float32), w if np.isscalar(w) else torch.tensor(w, dtype=torch.float32),
                    n) for v, w, n in vals])
    assert list(tout) == list(jout) == ["a", "b", "c"]
    for k in jout:
        for got, want in zip(tout[k], jout[k]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _criteria(xp, pkg):
    """{tag: criterion} of one package: a rotation term for both tags, a
    point term weighted by the step for one of them."""
    rot = pkg.Criterion("rot", lambda p, b: xp.abs(p["x"][:, 0] - b["y"][:, 0]), 1.0)
    pts = pkg.Criterion("pts", lambda p, b: xp.abs(p["x"][:, 1] - b["y"][:, 1]) ** 2, lambda step: 0.1 * step)
    return {"POSE": pkg.CriterionGroup([rot], "g/"), "BOTH": pkg.CriterionGroup([rot, pts], "g/", 0.5)}


def test_compute_loss_of_batches_matches_jax(rng):
    """Two sub-batches of different tags, one with a `dataset_weight`: the
    loss and every sub-batch's LossVals (names, values, weights)."""
    x = rng.randn(7, 2).astype(np.float32)
    sizes, tags = (3, 4), ("POSE", "BOTH")
    ys = [rng.randn(n, 2).astype(np.float32) for n in sizes]
    dw = rng.uniform(0.5, 2.0, 4).astype(np.float32)

    def subsets(B, M, asarray):
        out = []
        for i, (n, tag) in enumerate(zip(sizes, tags)):
            fields = {"y": asarray(ys[i])}
            if i == 1:
                fields["dataset_weight"] = asarray(dw)
            out.append(B(M(None, n, tag=tag), fields))
        return out

    jloss, jvals = JC.compute_loss_of_batches({"x": jnp.asarray(x)}, subsets(JBatch, JMetadata, jnp.asarray), 3,
                                              _criteria(jnp, JC))
    tloss, tvals = TC.compute_loss_of_batches({"x": t(x)}, subsets(Batch, Metadata, t), 3, _criteria(torch, TC))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert [[v.name for v in s] for s in tvals] == [[v.name for v in s] for s in jvals] == [["g/rot"], ["g/rot", "g/pts"]]
    for ts, js in zip(tvals, jvals):
        for tv, jv in zip(ts, js):
            np.testing.assert_allclose(tv.val.numpy(), np.asarray(jv.val), rtol=1e-6)
            np.testing.assert_allclose(tv.weight.numpy(), np.asarray(jv.weight), rtol=1e-6)
    # one criterion for every sub-batch
    one = TC.compute_loss_of_batches({"x": t(x)}, subsets(Batch, Metadata, t), 3, _criteria(torch, TC)["BOTH"])[0]
    jone = JC.compute_loss_of_batches({"x": jnp.asarray(x)}, subsets(JBatch, JMetadata, jnp.asarray), 3,
                                      _criteria(jnp, JC)["BOTH"])[0]
    np.testing.assert_allclose(float(one), float(jone), rtol=1e-6)


# ---- geometric augmentation ------------------------------------------------------------

def _smooth(rng, B, H, W):
    y, x = np.mgrid[:H, :W]
    out = np.zeros((B, H, W, 1), np.uint8)
    for i in range(B):
        k = rng.uniform(-0.1, 0.1, (2, 2))
        img = 127.5 + 63.5 * (np.sin(k[0, 0] * x + k[0, 1] * y) + np.sin(k[1, 0] * x + k[1, 1] * y + 1.0))
        out[i, ..., 0] = np.round(img)
    return out


@pytest.mark.parametrize("insert_backtransform", [False, True])
def test_focus_roi_batch_matches_jax(rng, insert_backtransform):
    B, H, W, S = 3, 90, 110, 48
    fields = dict(
        image=_smooth(rng, B, H, W),
        pose=_unit_quats(rng, B),
        coord=(np.asarray([55.0, 45.0, 20.0]) + rng.randn(B, 3) * 3).astype(np.float32),
        roi=np.asarray([[30.0, 25.0, 80.0, 70.0]] * B, np.float32) + rng.randn(B, 4).astype(np.float32),
        pt3d_68=(rng.rand(B, 68, 3) * [50, 45, 10] + [30, 25, -5]).astype(np.float32),
        shapeparam=rng.randn(B, 5).astype(np.float32),
    )
    if insert_backtransform:
        fields["image_backtransform"] = np.broadcast_to(np.float32([[1, 0, 2], [0, 1, -3]]), (B, 2, 3)).copy()
    names = dict(image="image", pose="quat", coord="xys", roi="roi", pt3d_68="points")
    scales, angles = rng.uniform(0.8, 1.3, B).astype(np.float32), rng.uniform(-0.5, 0.5, B).astype(np.float32)
    transl = rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32)
    jtr = JG.focus_roi_transform(jnp.asarray(fields["roi"]), JG.RoiFocusRandomizationParameters(
        jnp.asarray(scales), jnp.asarray(angles), jnp.asarray(transl)), S)
    ttr = TG.focus_roi_transform(t(fields["roi"]), TG.RoiFocusRandomizationParameters(t(scales), t(angles), t(transl)), S)
    jb = JBatch(JMetadata((W, H), B, categories={k: JFC[v] for k, v in names.items()}),
                {k: jnp.asarray(v) for k, v in fields.items()})
    tb = Batch(Metadata((W, H), B, categories={k: FieldCategory[v] for k, v in names.items()}),
               {k: t(v) for k, v in fields.items()})
    jout = JG.focus_roi_batch(jb, jtr, S, insert_backtransform=insert_backtransform)
    tout = TG.focus_roi_batch(tb, ttr, S, insert_backtransform=insert_backtransform)
    assert set(tout.keys()) == set(jout.keys()) and tout.meta.image_wh == jout.meta.image_wh == (S, S)
    assert tb.meta.image_wh == (W, H)  # the input keeps its size
    assert tuple(tout["image"].shape) == (B, S, S, 1)
    assert np.abs(tout["image"].numpy() - np.asarray(jout["image"])).max() <= 1e-3
    for k in set(jout.keys()) - {"image"}:
        np.testing.assert_allclose(np.asarray(tout[k], np.float64), np.asarray(jout[k], np.float64), rtol=1e-5,
                                   atol=1e-4, err_msg=k)


def test_random_flip_rot90_transform_with_injected_draws_matches_jax(rng, monkeypatch):
    """The draws go in through `sample_flip_rot90` of each package (patched
    to give the same choices); the generator reaches it as given."""
    B, S = 12, 129
    do_flip = rng.rand(B) < 0.5
    rot_dir = rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32)
    seen = []

    def port_draws(generator, batchshape, p_rot=0.01):
        seen.append((generator, tuple(batchshape), p_rot))
        return t(do_flip), t(rot_dir)

    monkeypatch.setattr(TG, "sample_flip_rot90", port_draws)
    monkeypatch.setattr(JG, "sample_flip_rot90", lambda key, shape, p_rot=0.01: (jnp.asarray(do_flip),
                                                                                 jnp.asarray(rot_dir)))
    gen = torch.Generator().manual_seed(3)
    out = TG.random_flip_rot90_transform(gen, (B,), S, p_rot=0.2).tensor().numpy()
    assert seen == [(gen, (B,), 0.2)]
    want = np.asarray(JG.random_flip_rot90_transform(jax.random.PRNGKey(0), (B,), S, p_rot=0.2).tensor())
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, TG.flip_rot90_transform(t(do_flip), t(rot_dir), S).tensor().numpy())


def test_random_flip_rot90_transform_draws_from_the_generator():
    """Unpatched: the generator's draws, `sample_flip_rot90`'s."""
    a = TG.random_flip_rot90_transform(torch.Generator().manual_seed(5), (64,), 129, p_rot=0.5).tensor()
    draws = TG.sample_flip_rot90(torch.Generator().manual_seed(5), (64,), 0.5)
    assert torch.equal(a, TG.flip_rot90_transform(*draws, 129).tensor())
    assert bool(draws[0].any()) and bool((draws[1] != 0).any())


def test_apply_fliprot_matches_jax(rng):
    B, S = 9, 17
    crop = rng.rand(B, S, S, 2).astype(np.float32)
    do_flip = np.asarray([0, 1, 0, 1, 0, 1, 0, 1, 1], bool)
    rot_dir = np.asarray([0, 0, 1, 1, -1, -1, 0, 1, -1], np.float32)
    for f, r in ((do_flip, rot_dir), (do_flip, None), (None, rot_dir), (None, None)):
        out = TWF.apply_fliprot(t(crop), None if f is None else t(f), None if r is None else t(r)).numpy()
        want = JWF.apply_fliprot(jnp.asarray(crop), None if f is None else jnp.asarray(f),
                                 None if r is None else jnp.asarray(r))
        np.testing.assert_array_equal(out, np.asarray(want))
    # the crop that a warp through `flip_rot90_transform` gives, pixel for pixel
    from neuralnet_tracker_traincode_torch.augmentation.warp import warp_affine

    warped = warp_affine(t(crop), TG.flip_rot90_transform(t(do_flip), t(rot_dir), S), S, oversample=1)
    np.testing.assert_allclose(TWF.apply_fliprot(t(crop), t(do_flip), t(rot_dir)).numpy(), warped.numpy(), atol=1e-5)


# ---- the diagonal scale head -----------------------------------------------------------

def test_features_as_diagonal_scale_carries_the_jax_weights(rng):
    import flax.linen as fnn

    class Head(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return JNLL.FeaturesAsDiagonalScale(5, name="uncertainty_scales")(x)

    x = rng.randn(6, 12).astype(np.float32)
    params = Head().init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(np.float32), params)
    want = np.asarray(Head().apply({"params": params}, jnp.asarray(x)))

    head = TNLL.FeaturesAsDiagonalScale(12, 5)
    head.load_state_dict(diagonal_scale_state_dict_from_jax(params))
    out = head(t(x)).detach().numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
    assert (out > 0).all() and out.shape == (6, 5)
    back = diagonal_scale_params_to_jax(head.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.tree_util.tree_map(np.asarray, params))
    # under bf16 autocast the neck stays f32, as in the network's other heads
    with torch.autocast("cpu", dtype=torch.bfloat16):
        np.testing.assert_array_equal(head(t(x)).detach().numpy(), out)
    # the optimizer puts it into the 'variance' group (0.1x lr), as the JAX package its `uncertainty*` modules
    net = torch.nn.Sequential(torch.nn.Linear(3, 12), head)
    assert label_parameters(net) == {"0.weight": "main", "0.bias": "main", "1.neck.lin.weight": "variance",
                                     "1.neck.lin.bias": "variance"}


def test_inv_make_positive_matches_jax(rng):
    y = np.concatenate([rng.uniform(1e-3, 5.0, 100), [1.0, 0.5, 2.0]]).astype(np.float32)
    inv = TNLL.inv_make_positive(t(y))
    np.testing.assert_allclose(inv.numpy(), np.asarray(JNLL.inv_make_positive(jnp.asarray(y))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TNLL.make_positive(inv).numpy(), y, rtol=1e-6)


# ---- the landmark groups ---------------------------------------------------------------

_GROUPS = sorted(k for k, v in vars(JK).items() if not k.startswith("_") and isinstance(v, (int, list)))


def test_every_landmark_group_is_ported():
    # the 22 named groups beside flip_map, chin_left, chin_right and eye_not_corners, which the port had
    assert len(_GROUPS) == 26 and "flip_map" in _GROUPS
    assert sorted(k for k, v in vars(TK).items() if not k.startswith("_") and isinstance(v, (int, list))) == _GROUPS


@pytest.mark.parametrize("name", _GROUPS)
def test_landmark_group_is_the_jax_one(name):
    assert getattr(TK, name) == getattr(JK, name)
    members = getattr(TK, name)
    for i in members if isinstance(members, list) else [members]:
        assert 0 <= i < 68
