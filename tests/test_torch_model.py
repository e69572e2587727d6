"""Parity of the port's pose network, weight bridge and flagship loss with the
JAX package's, on the same weights (moved across by the port's bridge).

Tolerances (all f32 on the CPU; the two frameworks sum convolutions in
another order):
 - forward outputs: rtol 1e-4, atol 1e-5 through the 14 convolution layers;
 - BatchNorm running statistics after one train-mode forward: rtol 1e-4
   (a torch-style unbiased variance would move the last blocks' running
   variance by 0.1 * var / 49, about 2e-3 of it, far outside that);
 - loss 1e-5 relative, gradients: relative error of each leaf <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.models.torch_export import export_posenet_state_dict
from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead as TNet
from neuralnet_tracker_traincode_torch.models.weights import posenet_state_dict_from_jax
from tests.torch_port_helpers import (
    SMALL_NET,
    flagship_criteria,
    jax_posenet_variables,
    leaf_rel_err,
    normalized_labels,
    t,
    torch_posenet,
)

_OUT_KEYS = (
    "coord", "roi", "unnormalized_quat", "pose_scales_tril", "coord_scales", "roi_scales",
    "pt3d_68", "shapeparam", "pt3d_68_scales", "shapeparam_scales",
)


def _inputs(seed, B):
    rng = np.random.RandomState(seed)
    x = (rng.rand(B, 129, 129, 1) - 0.5).astype(np.float32)
    conv = rng.randint(0, 8, size=(B,)).astype(np.int32)
    return rng, x, conv


def _compare_outputs(out, ref):
    np.testing.assert_allclose(out["rot"].value.detach().numpy(), np.asarray(ref["rot"].value), rtol=1e-4, atol=1e-5)
    for k in _OUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("blurpool", [False, True])
def test_weight_bridge_matches_reference_export(blurpool):
    """Key for key and value for value against `export_posenet_state_dict`,
    and loadable into the port's network without missing or extra keys."""
    net = dict(SMALL_NET, backbone_args={"widen_factor": 0.25, "use_blurpool": blurpool})
    _, variables = jax_posenet_variables(0, **net)
    ours = posenet_state_dict_from_jax(variables, net)
    ref = export_posenet_state_dict(variables, net)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    model = TNet(**net)
    missing, unexpected = model.load_state_dict(ours, strict=True)
    assert not missing and not unexpected
    assert set(model.state_dict()) == set(ref)


def test_forward_eval_mode_matches_jax():
    jmodel, variables = jax_posenet_variables(1, **SMALL_NET)
    _, x, conv = _inputs(1, 3)
    ref = jmodel.apply(variables, jnp.asarray(x), coord_convention_id=jnp.asarray(conv), train=False)
    model = torch_posenet(variables, **SMALL_NET).eval()
    with torch.no_grad():
        out = model(t(x), coord_convention_id=t(conv))
    _compare_outputs(out, ref)
    np.testing.assert_allclose(out["pose"].numpy(), np.asarray(ref["pose"]), rtol=1e-4, atol=1e-5)


def test_forward_train_mode_and_batchnorm_statistics_match_jax():
    """B=2: the final blocks normalise over 2 x 5 x 5 values, where the
    biased and unbiased variances differ by 50/49."""
    jmodel, variables = jax_posenet_variables(2, **SMALL_NET)
    _, x, conv = _inputs(2, 2)
    ref, mutated = jmodel.apply(
        variables, jnp.asarray(x), coord_convention_id=jnp.asarray(conv), train=True, mutable=["batch_stats"]
    )
    model = torch_posenet(variables, **SMALL_NET).train()
    with torch.no_grad():
        out = model(t(x), coord_convention_id=t(conv))
    _compare_outputs(out, ref)
    assert "pose" not in out
    expect = posenet_state_dict_from_jax({"params": variables["params"], "batch_stats": mutated["batch_stats"]}, SMALL_NET)
    got = model.state_dict()
    stats = [k for k in expect if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 27
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), expect[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_flagship_loss_and_gradients_match_jax():
    """The 8-term criterion on train-mode outputs, and d loss / d params."""
    jmodel, variables = jax_posenet_variables(3, **SMALL_NET)
    rng, x, conv = _inputs(3, 4)
    labels = normalized_labels(rng, 4)
    tag = np.zeros((4,), np.int32)
    jcrit, tcrit = flagship_criteria()
    W = jcrit.weight_matrix(0)

    def jloss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            coord_convention_id=jnp.asarray(conv), train=True, mutable=["batch_stats"],
        )
        loss, _ = jcrit(out, {k: jnp.asarray(v) for k, v in labels.items()}, jnp.asarray(tag), jnp.asarray(W))
        return loss

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    model = torch_posenet(variables, **SMALL_NET).train()
    out = model(t(x), coord_convention_id=t(conv))
    loss, byname = tcrit(out, {k: t(v) for k, v in labels.items()}, t(tag), t(W))
    assert set(byname) == {"nllrot", "nllcoord", "rot", "xy", "sz", "points3d", "box", "quatreg"}
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    loss.backward()
    expect = posenet_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, ref_grads), "batch_stats": variables["batch_stats"]}, SMALL_NET
    )
    names = dict(model.named_parameters())
    assert len(names) == 100 and set(names) <= set(expect)
    unused = {k for k, p in names.items() if p.grad is None}
    # the box, point and shape scales feed no flagship term: zero in JAX
    assert unused == {f"{m}.hidden_scale" for m in ("boxnet.scales", "landmarks.point_distrib_scales", "landmarks.shape_distrib_scales")}
    for k, p in names.items():
        g = np.zeros(tuple(p.shape), np.float32) if k in unused else p.grad.numpy()
        assert leaf_rel_err(g, expect[k].numpy()) <= 1e-4, k


def test_default_device_is_cuda():
    """The model itself follows `.to(device)`; the entry points that place it
    (PoseTrainer) default to CUDA and raise without it."""
    from neuralnet_tracker_traincode_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


SIXD_NET = dict(SMALL_NET, enable_6drot=True)


@pytest.mark.parametrize("train", [False, True])
def test_6d_rotation_model_forward_matches_jax(train):
    """The 6D head through the bridge: Gram-Schmidt in f32, the identity
    fallback, the local pose offsets as matrices; eval mode adds the
    quaternion from the matrix."""
    jmodel, variables = jax_posenet_variables(5, **SIXD_NET)
    _, x, conv = _inputs(5, 3)
    ref = jmodel.apply(variables, jnp.asarray(x), coord_convention_id=jnp.asarray(conv), train=train,
                       mutable=["batch_stats"] if train else False)
    ref = ref[0] if train else ref
    model = torch_posenet(variables, **SIXD_NET).train(train)
    with torch.no_grad():
        out = model(t(x), coord_convention_id=t(conv))
    assert type(out["rot"]).__name__ == "Mat33Repr" and out["rot"].value.shape == (3, 3, 3)
    np.testing.assert_allclose(out["rot"].value.numpy(), np.asarray(ref["rot"].value), rtol=1e-4, atol=1e-5)
    keys = set(_OUT_KEYS) - {"unnormalized_quat"} | {"unnormalized_6drepr"}
    for k in sorted(keys):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert ("pose" in out) == (not train)
    if not train:
        np.testing.assert_allclose(out["pose"].numpy(), np.asarray(ref["pose"]), rtol=1e-4, atol=1e-5)


def test_6d_head_init_and_config_match_jax():
    from neuralnet_tracker_traincode_tpu.models.posenet import NetworkWithPointHead as JNet

    model = TNet(**SIXD_NET)
    model.init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(model.quatnet.linear.bias.detach().numpy(),
                                  np.float32(0.001) * np.asarray([1, 0, 0, 0, 1, 0], np.float32))
    assert model.get_config() == JNet(**SIXD_NET).get_config()
    assert TNet(**SMALL_NET).get_config() == JNet(**SMALL_NET).get_config()


@pytest.mark.parametrize("net", ["6d", "quat_blurpool", "no_uncertainty_no_points"])
def test_weight_bridge_inverse_restores_the_jax_tree(net):
    """`posenet_variables_to_jax` gives back the JAX package's variables tree
    exactly (keys, shapes, dtypes, values), and from_jax(to_jax(sd)) == sd."""
    import jax

    from neuralnet_tracker_traincode_torch.models.weights import posenet_variables_to_jax

    cfg = {
        "6d": SIXD_NET,
        "quat_blurpool": dict(SMALL_NET, backbone_args={"widen_factor": 0.25, "use_blurpool": True}),
        "no_uncertainty_no_points": dict(SMALL_NET, enable_uncertainty=False, enable_point_head=False),
    }[net]
    _, variables = jax_posenet_variables(6, **cfg)
    sd = posenet_state_dict_from_jax(variables, cfg)
    back = posenet_variables_to_jax(sd, cfg)
    flat = lambda tree: {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}  # noqa: E731
    got, want = flat(back), flat(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == np.shape(v), k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    again = posenet_state_dict_from_jax(back, cfg)
    assert set(again) == set(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k
    if net == "6d":
        ref = export_posenet_state_dict(variables, cfg)
        assert set(sd) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
