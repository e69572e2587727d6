"""The port's ONNX writer (`export/onnx_export.py`, `onnx_proto.py`), its
conformance check and its executor on the files, against the JAX package's
exporter, on the CPU. The other backbones are in
`test_torch_export_backbones.py`.

Weights: the JAX package's init of each network with every parameter
perturbed and the BatchNorm statistics randomised
(`torch_port_helpers.jax_posenet_variables`; the localizer's as the JAX
package's `tests/test_onnx_export.py` perturbs it), carried into the port
by `posenet_state_dict_from_jax` / `localizer_state_dict_from_jax`.

Gates:
 - the port's file is byte-equal to the JAX exporter's for the same weights:
   MobileNetV1 (widen 0.25) with the point and NLL heads, `opentrack` and
   `full`; the 6D head, both; MobileNetV1 with BlurPool; fp16; int8 with
   the same `quant_ranges`; the localizer;
 - `TorchOnnxSession(device="cpu")` against the JAX `NumpyOnnxSession` on
   the same bytes: every output within 1e-5 (f32 files) or 1e-3 (fp16 and
   int8 files);
 - the file against the port's eager forward (f32): 1e-4 (the export CLI's
   check), 5e-2 for fp16, 2e-1 for int8 without the scale heads;
 - `calibrate_conv_ranges` on the port's executor against the JAX function
   on the same batches: 1e-5 relative;
 - `validate_model` accepts every file the JAX validator accepts, and
   rejects each malformed graph of the JAX package's
   `tests/test_onnx_conformance.py` with the same error and message;
 - `clear_denormals` equals the JAX function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.export import onnx_conformance as JC
from neuralnet_tracker_traincode_tpu.export import onnx_export as JE
from neuralnet_tracker_traincode_tpu.export import onnx_run as JR
from neuralnet_tracker_traincode_torch.export import onnx_conformance as TC
from neuralnet_tracker_traincode_torch.export import onnx_export as TE
from neuralnet_tracker_traincode_torch.export import onnx_proto as P
from neuralnet_tracker_traincode_torch.export.onnx_run import TorchOnnxSession
from torch_port_helpers import SMALL_NET, jax_posenet_variables, torch_posenet
from torch_port_helpers import two_intra_op_threads  # noqa: F401 - autouse: full-width localizer on the CPU

NETS = {
    "mobilenet": SMALL_NET,
    "6d": dict(SMALL_NET, enable_6drot=True),
    "mobilenet_blurpool": dict(SMALL_NET, backbone_args={"widen_factor": 0.25, "use_blurpool": True}),
}
# (network, outputs, precision)
CASES = [
    ("mobilenet", "opentrack", "f32"),
    ("mobilenet", "full", "f32"),
    ("6d", "opentrack", "f32"),
    ("6d", "full", "f32"),
    ("mobilenet_blurpool", "opentrack", "f32"),
    ("mobilenet", "opentrack", "fp16"),
    ("6d", "full", "fp16"),
    ("mobilenet", "opentrack", "int8"),
    ("localizer", None, "f32"),
]
OPENTRACK = {"pos_size": "coord", "quat": "pose", "box": "roi", "pos_size_scales": "coord_scales",
             "rotaxis_scales_tril": "pose_scales_tril", "box_scales": "roi_scales"}


def case_id(case):
    return "-".join(c for c in case if c)


def _inputs(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) - 0.5


@functools.cache
def networks(name):
    """(JAX module, JAX variables, the port's module) with the same weights."""
    if name == "localizer":
        from neuralnet_tracker_traincode_tpu.models.localizer import LocalizerNet as JLoc
        from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet
        from neuralnet_tracker_traincode_torch.models.weights import localizer_state_dict_from_jax

        jmodel = JLoc()
        v = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 224, 288, 1)))
        stats = jax.tree_util.tree_map_with_path(
            lambda path, x: np.asarray(x) * 1.7 + 0.05 if "var" in jax.tree_util.keystr(path) else np.asarray(x) + 0.01,
            v["batch_stats"])
        variables = {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}
        model = LocalizerNet()
        model.load_state_dict(localizer_state_dict_from_jax(variables))
        return jmodel, variables, model.eval()
    jmodel, variables = jax_posenet_variables(3, **NETS[name])
    return jmodel, variables, torch_posenet(variables, **NETS[name]).eval()


@functools.cache
def quant_ranges():
    """The JAX package's calibration of the mobilenet file on one batch: the
    ranges both builders are given."""
    jmodel, variables, _ = networks("mobilenet")
    return JE.calibrate_conv_ranges(JE.build_posenet_onnx(jmodel, variables), [_inputs((2, 1, 129, 129), 5)])


@functools.cache
def files(case):
    """(JAX exporter's bytes, the port's bytes) of a case."""
    name, outputs, precision = case
    jmodel, variables, model = networks(name)
    if name == "localizer":
        return JE.build_localizer_onnx(jmodel, variables), TE.build_localizer_onnx(model)
    kw = dict(outputs=outputs, fp16=precision == "fp16", quant_ranges=quant_ranges() if precision == "int8" else None)
    return JE.build_posenet_onnx(jmodel, variables, **kw), TE.build_posenet_onnx(model, **kw)


def _input_shape(case, batch=2):
    return (batch, 1, 224, 288) if case[0] == "localizer" else (batch, 1, 129, 129)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_file_is_byte_equal_to_the_jax_exporter(case):
    theirs, ours = files(case)
    assert len(ours) == len(theirs) and ours == theirs


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_torch_session_matches_numpy_session(case):
    _, blob = files(case)
    x = _inputs(_input_shape(case))
    ref = JR.NumpyOnnxSession(blob)
    sess = TorchOnnxSession(blob, device="cpu")
    assert sess.output_names == ref.output_names and sess.model_version == ref.model_version == 4
    assert sess.input_dims == ref.input_dims and sess.device.type == "cpu"
    tol = 1e-5 if case[2] == "f32" else 1e-3
    for name, a, b in zip(sess.output_names, sess.run(None, {"x": torch.from_numpy(x)}), ref.run(None, {"x": x})):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_file_against_the_eager_network(case):
    _, blob = files(case)
    _, _, model = networks(case[0])
    x = _inputs(_input_shape(case), seed=1)
    sess = TorchOnnxSession(blob, device="cpu")
    got = dict(zip(sess.output_names, sess.run(None, {"x": x})))
    with torch.no_grad():
        eager = model(torch.from_numpy(x).permute(0, 2, 3, 1))
    if case[0] == "localizer":
        want = {"logit_box": eager}
    elif case[1] == "full":
        want = {k: eager[k] for k in sess.output_names}
    else:
        want = {k: eager[v] for k, v in OPENTRACK.items() if k in sess.output_names}
    assert set(want) == set(got)
    tol = {"f32": 1e-4, "fp16": 5e-2, "int8": 2e-1}[case[2]]
    for k, v in want.items():
        if case[2] == "int8" and "scales" in k:
            continue  # informational in the export CLI too: the scale heads amplify quantization noise
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_validator_accepts_what_the_jax_validator_accepts(case):
    _, blob = files(case)
    ours, theirs = TC.validate_model(blob), JC.validate_model(blob)
    assert ours == theirs  # the decoded models, field for field
    assert ours.opset_imports[""] == 13 and ours.model_version == 4 and ours.ir_version == 8
    assert all(vi.elem_type == TC.T_FLOAT for vi in ours.graph.inputs + ours.graph.outputs)
    ops = {n.op_type for n in ours.graph.nodes}
    assert ("QuantizeLinear" in ops) == (case[2] == "int8") and ("BatchNormalization" not in ops)


def test_calibration_matches_jax():
    jmodel, variables, model = networks("mobilenet")
    blob = TE.build_posenet_onnx(model)
    batches = [_inputs((2, 1, 129, 129), 5), _inputs((3, 1, 129, 129), 6)]
    ours = TE.calibrate_conv_ranges(blob, [torch.from_numpy(b) for b in batches], device="cpu")
    theirs = JE.calibrate_conv_ranges(blob, batches)
    assert len(ours) == len(theirs) == 27  # every backbone conv
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=1e-5, atol=0)


def test_clear_denormals_is_the_jax_function():
    tree = {"a": np.asarray([1e-30, 1.0, -1e-25, 3e-21], np.float32),
            "b": {"c": np.asarray([[-2e-20, 5e-39]], np.float64), "n": np.asarray(7, np.int64)},
            "d": [np.float32([1e-21, -0.5])]}
    ours, theirs = TE.clear_denormals(tree), JE.clear_denormals(tree)
    leaves, ref = jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(leaves, ref):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours["a"], [0.0, 1.0, 0.0, 0.0])


# ---- malformed graphs: the checker catches emission faults ------------------------------------------------------


def _mini_model(nodes, extra_graph=b""):
    inp = P.value_info_proto("x", TC.T_FLOAT, ["batch", 4])
    out = P.value_info_proto("y", TC.T_FLOAT, ["batch", 4])
    graph = P.field_string(2, "g") + b"".join(P.field_message(1, n) for n in nodes)
    return P.model_proto(graph + P.field_message(11, inp) + P.field_message(12, out) + extra_graph)


def _bad_initializer():
    t = P.field_string(8, "w") + P.field_varint(2, TC.T_FLOAT) + P.field_varint(1, 4) + P.field_bytes(9, b"\x00" * 8)
    return _mini_model([P.node_proto("Add", ["x", "w"], ["y"])], P.field_message(5, t))


MALFORMED = {
    "post13_attribute": ("allowzero", lambda: _mini_model(
        [P.node_proto("Reshape", ["x", "shape"], ["y"], allowzero=1)],
        P.field_message(5, P.tensor_proto("shape", np.asarray([0, 4], np.int64))))),
    "wrong_attribute_type": ("axis", lambda: _mini_model([P.node_proto("Concat", ["x", "x"], ["y"], axis=0.0)])),
    "missing_required_attribute": ("to", lambda: _mini_model([P.node_proto("Cast", ["x"], ["y"])])),
    "use_before_def": ("topological", lambda: _mini_model(
        [P.node_proto("Relu", ["t"], ["y"]), P.node_proto("Relu", ["x"], ["t"])])),
    "ssa_violation": ("redefined", lambda: _mini_model(
        [P.node_proto("Relu", ["x"], ["y"]), P.node_proto("Abs", ["x"], ["y"])])),
    "wrong_arity": ("inputs", lambda: _mini_model([P.node_proto("Add", ["x"], ["y"])])),
    "unknown_op": ("opset-13 table", lambda: _mini_model([P.node_proto("NotAnOp", ["x"], ["y"])])),
    "bad_initializer_size": ("raw_data length", _bad_initializer),
    "unsqueeze_axes_attribute": ("axes", lambda: _mini_model(
        [P.node_proto("Unsqueeze", ["x", "axes_in"], ["y"], axes=[0])],
        P.field_message(5, P.tensor_proto("axes_in", np.asarray([0], np.int64))))),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_validator_rejects_malformed_graph(name):
    match, make = MALFORMED[name]
    blob = make()
    with pytest.raises(TC.ConformanceError, match=match) as ours:
        TC.validate_model(blob)
    with pytest.raises(JC.ConformanceError) as theirs:
        JC.validate_model(blob)
    assert str(ours.value) == str(theirs.value)
