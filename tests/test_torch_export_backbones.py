"""The port's ONNX writer and executor on the other backbones, against the
JAX package's exporter, on the CPU (the MobileNetV1 family, fp16, int8 and
the localizer are in `test_torch_export.py`).

Weights: the port's init of each network at full width, moved into the
JAX layout by the port's bridge (`models/weights.py:
posenet_variables_to_jax`), then every parameter perturbed and the
BatchNorm statistics randomised as `torch_port_helpers.
jax_posenet_variables` does; the port's module gets them back through
`posenet_state_dict_from_jax`. (The JAX package's own init of these three
backbones takes over a minute on the CPU; the exporter reads nothing but
the variables and the module's configuration.)

Gates, as in `test_torch_export.py`: the file byte-equal to the JAX
exporter's; `TorchOnnxSession(device="cpu")` within 1e-5 of the JAX
`NumpyOnnxSession` on the same bytes; the file within 1e-4 of the port's
eager forward; the JAX validator's decoded model equal to the port's.
Configurations: resnet18 with BlurPool and the face detector head (`full`),
efficientnet_b0 (`opentrack`), hybrid_vit (`full`).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.export import onnx_conformance as JC
from neuralnet_tracker_traincode_tpu.export import onnx_export as JE
from neuralnet_tracker_traincode_tpu.export import onnx_run as JR
from neuralnet_tracker_traincode_tpu.models.posenet import NetworkWithPointHead as JNet
from neuralnet_tracker_traincode_torch.export import onnx_conformance as TC
from neuralnet_tracker_traincode_torch.export import onnx_export as TE
from neuralnet_tracker_traincode_torch.export.onnx_run import TorchOnnxSession
from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead as TNet
from neuralnet_tracker_traincode_torch.models.weights import posenet_variables_to_jax
from torch_port_helpers import torch_posenet
from torch_port_helpers import two_intra_op_threads  # noqa: F401 - autouse: full-width backbones on the CPU

HEADS = dict(enable_point_head=True, enable_uncertainty=True)
CASES = {
    "resnet18_blurpool": (dict(HEADS, config="resnet18", backbone_args={"use_blurpool": True},
                               enable_face_detector=True), "full"),
    "efficientnet_b0": (dict(HEADS, config="efficientnet_b0"), "opentrack"),
    "hybrid_vit": (dict(HEADS, config="hybrid_vit"), "full"),
}
OPENTRACK = {"pos_size": "coord", "quat": "pose", "box": "roi", "pos_size_scales": "coord_scales",
             "rotaxis_scales_tril": "pose_scales_tril", "box_scales": "roi_scales"}


@functools.cache
def networks(name, seed=4):
    """(JAX module, JAX variables, the port's module) with the same weights."""
    net = CASES[name][0]
    model = TNet(**net)
    model.init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    variables = posenet_variables_to_jax(model.state_dict(), net)
    params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
                                    variables["params"])

    def stat(path, a):
        if getattr(path[-1], "key", "") == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)

    variables = {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}
    return JNet(**net), variables, torch_posenet(variables, **net).eval()


@functools.cache
def files(name):
    jmodel, variables, model = networks(name)
    outputs = CASES[name][1]
    return JE.build_posenet_onnx(jmodel, variables, outputs=outputs), TE.build_posenet_onnx(model, outputs=outputs)


def _inputs(batch, seed):
    return np.random.RandomState(seed).rand(batch, 1, 129, 129).astype(np.float32) - 0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_file_is_byte_equal_to_the_jax_exporter(name):
    theirs, ours = files(name)
    assert len(ours) == len(theirs) and ours == theirs


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_session_matches_numpy_session(name):
    _, blob = files(name)
    x = _inputs(2, 0)
    ref = JR.NumpyOnnxSession(blob)
    sess = TorchOnnxSession(blob, device="cpu")
    assert sess.output_names == ref.output_names
    for k, a, b in zip(sess.output_names, sess.run(None, {"x": x}), ref.run(None, {"x": x})):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_file_against_the_eager_network(name):
    _, blob = files(name)
    _, _, model = networks(name)
    x = _inputs(2, 1)
    sess = TorchOnnxSession(blob, device="cpu")
    got = dict(zip(sess.output_names, sess.run(None, {"x": x})))
    with torch.no_grad():
        eager = model(torch.from_numpy(x).permute(0, 2, 3, 1))
    want = {k: eager[k] for k in got} if CASES[name][1] == "full" else {k: eager[v] for k, v in OPENTRACK.items()}
    assert set(want) == set(got)
    if name == "resnet18_blurpool":
        assert {"hasface", "hasface_logits", "pt3d_68"} <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_validator_accepts_what_the_jax_validator_accepts(name):
    _, blob = files(name)
    ours = TC.validate_model(blob)
    assert ours == JC.validate_model(blob)
    ops = {n.op_type for n in ours.graph.nodes}
    if name == "hybrid_vit":
        assert {"Softmax", "MatMul", "ReduceMean", "Sqrt"} <= ops  # attention and LayerNorm decomposed
    if name == "resnet18_blurpool":
        assert "MaxPool" not in ops  # the stem's pool is a blur pool
