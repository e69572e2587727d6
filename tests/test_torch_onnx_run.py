"""The port's ONNX executor (`export/onnx_run.py`) and `OnnxPoseNetwork`
against the JAX package's, on the CPU.

 - One graph per op whose semantics are easy to get wrong, run by the
   port's `run` and by the JAX numpy executor, bit-equal and equal to the
   values written out: `QuantizeLinear` at exact .5 steps (half to even)
   and at saturation; per-channel `DequantizeLinear`; `MaxPool` at the
   padded border (-inf padding); `Reshape` with 0; `ArgMax` with and
   without `keepdims`, at ties; `Cast` to fp16.
 - `TorchOnnxSession` runs on CUDA unless asked for the CPU (here it raises
   rather than fall back), reads a path or bytes, and keeps the int64
   operands on the host.
 - `OnnxPoseNetwork` against the JAX `OnnxPoseNetwork` over its
   `NumpyOnnxSession` (onnxruntime is absent, and its first choice,
   `JaxOnnxSession`, is refused here: the JAX legacy remap writes into the
   read-only arrays that session returns, a reference defect): on a
   JAX-written file, on a port-written one (the same bytes) and on a
   `model_version` 1 file (the legacy quaternion remap), every output within
   1e-5; a fixed batch of one runs frame by frame; a symbolic or implausible
   input size falls back to 129.
 - The evaluation table's row of `Predictor.evaluate` on a `--full` file
   against the JAX script's `report()` on the same file: <= 1e-3 in every
   column (the crops differ by an ulp of the transform, as for checkpoints,
   `test_torch_eval.py`).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.eval.predictor import OnnxPoseNetwork as JOnnx
from neuralnet_tracker_traincode_tpu.export import onnx_export as JE
from neuralnet_tracker_traincode_tpu.export import onnx_run as JR
from neuralnet_tracker_traincode_torch.eval.predictor import OnnxPoseNetwork, Predictor, load_pose_network
from neuralnet_tracker_traincode_torch.eval.report import RoiConfig, TableBuilder, add_report_row
from neuralnet_tracker_traincode_torch.export import onnx_export as TE
from neuralnet_tracker_traincode_torch.export import onnx_proto as P
from neuralnet_tracker_traincode_torch.export import onnx_run as TR
from tests.test_torch_eval import _jax_report_row, synthetic_set  # noqa: F401 - a fixture
from torch_port_helpers import SMALL_NET, jax_posenet_variables, torch_posenet


def _graph(nodes, inits, x_dtype=P.FLOAT, x_shape=("batch", 4), y_dtype=P.FLOAT, y_shape=("batch", 4), version=4,
           y="y"):
    """A model of `nodes` (op, inputs, attrs) from "x" to `y`, tensors named t0, t1, ..."""
    protos = []
    for k, (op, ins, attrs) in enumerate(nodes):
        out = y if k == len(nodes) - 1 else f"t{k}"
        protos.append(P.node_proto(op, ins, [out], name=f"n{k}", **attrs))
    graph = P.graph_proto("g", protos, [P.value_info_proto("x", x_dtype, list(x_shape))],
                          [P.value_info_proto(y, y_dtype, list(y_shape))],
                          [P.tensor_proto(k, v) for k, v in inits.items()])
    return P.model_proto(graph, model_version=version)


def _both(blob, x):
    """(the port's output on the CPU, the JAX numpy executor's)."""
    ours = TR.run(TR.load_model(blob), {"x": torch.from_numpy(x)}, device="cpu")["y"]
    theirs = JR.run(JR.load_model(blob), {"x": x})["y"]
    assert ours.numpy().dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.numpy(), theirs)
    return ours.numpy()


@pytest.mark.parametrize("zp,want", [
    (np.uint8(0), [0, 0, 0, 2, 2, 4, 255, 0]),
    (np.uint8(128), [126, 128, 128, 130, 130, 132, 255, 0]),
    (np.int8(0), [-2, 0, 0, 2, 2, 4, 127, -128]),
])
def test_quantize_rounds_half_to_even_and_saturates(zp, want):
    x = np.float32([[-1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 300.0, -300.0]])
    ty = P.UINT8 if zp.dtype == np.uint8 else P.INT8
    blob = _graph([("QuantizeLinear", ["x", "s", "z"], {})], {"s": np.asarray(1.0, np.float32), "z": np.asarray(zp)},
                  x_shape=("batch", 8), y_dtype=ty, y_shape=("batch", 8))
    np.testing.assert_array_equal(_both(blob, x), np.asarray([want], zp.dtype))


def test_dequantize_per_channel():
    rng = np.random.RandomState(0)
    q = rng.randint(-127, 128, (4, 3, 2, 2)).astype(np.int8)
    scale = np.float32([0.5, 0.25, 2.0, 1e-3])
    zp = np.zeros(4, np.int8)
    blob = _graph([("DequantizeLinear", ["q", "s", "z"], {"axis": 0}), ("Add", ["t0", "x"], {})],
                  {"q": q, "s": scale, "z": zp}, x_shape=(4, 3, 2, 2), y_shape=(4, 3, 2, 2))
    out = _both(blob, np.zeros((4, 3, 2, 2), np.float32))
    np.testing.assert_array_equal(out, q.astype(np.float32) * scale[:, None, None, None])


def test_maxpool_pads_with_minus_infinity():
    x = -1.0 - np.arange(2 * 3 * 5 * 6, dtype=np.float32).reshape(2, 3, 5, 6)  # all negative: 0-padding would win
    blob = _graph([("MaxPool", ["x"], {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]})], {},
                  x_shape=(2, 3, 5, 6), y_shape=(2, 3, 3, 3))
    out = _both(blob, x)
    assert out.shape == (2, 3, 3, 3) and out.max() < 0
    np.testing.assert_array_equal(out[:, :, 0, 0], x[:, :, 0, 0])  # the corner window holds one real pixel of 4


def test_reshape_zero_keeps_the_dimension():
    blob = _graph([("Reshape", ["x", "shape"], {})], {"shape": np.asarray([0, -1, 2], np.int64)},
                  x_shape=(3, 8), y_shape=(3, 4, 2))
    x = np.arange(24, dtype=np.float32).reshape(3, 8)
    np.testing.assert_array_equal(_both(blob, x), x.reshape(3, 4, 2))


@pytest.mark.parametrize("keepdims", [1, 0])
def test_argmax_keepdims_and_ties(keepdims):
    x = np.float32([[1, 3, 3, 0], [2, 2, 2, 2], [-1, -5, 0, 0]])
    blob = _graph([("ArgMax", ["x"], {"axis": 1, "keepdims": keepdims})], {}, x_shape=(3, 4), y_dtype=P.INT64,
                  y_shape=(3, 1) if keepdims else (3,))
    want = np.int64([1, 0, 2])  # the first of equal maxima
    np.testing.assert_array_equal(_both(blob, x), want[:, None] if keepdims else want)


def test_cast_to_fp16():
    x = np.float32([[1.0 + 2 ** -11, 65504.0, 70000.0, 1e-8, -3.14159, 2 ** -24, 0.1, -0.0]])
    blob = _graph([("Cast", ["x"], {"to": P.FLOAT16})], {}, x_shape=(1, 8), y_dtype=P.FLOAT16, y_shape=(1, 8))
    np.testing.assert_array_equal(_both(blob, x), x.astype(np.float16))


def test_session_runs_on_the_card_unless_asked(tmp_path):
    blob = _graph([("Slice", ["x", "st", "en", "ax"], {})],
                  {"st": np.int64([1]), "en": np.int64([3]), "ax": np.int64([1])}, y_shape=("batch", 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.TorchOnnxSession(blob)
    path = tmp_path / "s.onnx"
    path.write_bytes(blob)
    sess = TR.TorchOnnxSession(str(path), device="cpu")
    assert isinstance(sess._inits["st"], np.ndarray)  # index operands stay on the host
    (y,) = sess.run(["y"], {"x": np.arange(8, dtype=np.float32).reshape(2, 4)})
    np.testing.assert_array_equal(y.numpy(), [[1, 2], [5, 6]])


# ---- OnnxPoseNetwork -------------------------------------------------------------------------------------------


@functools.cache
def _network(kind):
    net = dict(SMALL_NET, enable_6drot=kind == "6d")
    jmodel, variables = jax_posenet_variables(11, **net)
    return jmodel, variables, torch_posenet(variables, **net).eval()


def _with_version(blob, version):
    graph = next(v for f, _, v in P.decode_raw(blob) if f == 7)
    return P.model_proto(graph, model_version=version)


@functools.cache
def _files(tmp):
    jmodel, variables, model = _network("6d")
    theirs = JE.build_posenet_onnx(jmodel, variables, outputs="full")
    ours = TE.build_posenet_onnx(model, outputs="full")
    paths = {"jax": f"{tmp}/jax.onnx", "port": f"{tmp}/port.onnx", "legacy": f"{tmp}/legacy.onnx"}
    for name, blob in (("jax", theirs), ("port", ours), ("legacy", _with_version(ours, 1))):
        with open(paths[name], "wb") as f:
            f.write(blob)
    return paths


@pytest.fixture(scope="module")
def onnx_files(tmp_path_factory):
    return _files(str(tmp_path_factory.mktemp("onnx")))


@pytest.mark.parametrize("which", ["jax", "port", "legacy"])
def test_onnx_pose_network_matches_jax(onnx_files, which, monkeypatch):
    def refused(*args, **kwargs):
        raise RuntimeError("the numpy executor, as where onnxruntime is absent")

    monkeypatch.setattr(JR, "JaxOnnxSession", refused)
    path = onnx_files[which]
    ours, theirs = load_pose_network(path, device="cpu"), JOnnx(path)
    assert isinstance(ours, OnnxPoseNetwork) and ours.device.type == "cpu"
    assert ours.input_resolution == theirs.input_resolution == 129
    assert ours.output_names == theirs.output_names and "coord" in ours.output_names
    assert ours._legacy_coords == theirs._legacy_coords == (which == "legacy")
    x = np.random.RandomState(2).rand(3, 129, 129, 1).astype(np.float32) - 0.5
    got, want = ours(torch.from_numpy(x)), theirs(jnp.asarray(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
    if which == "legacy":  # the remap: (x, y, z, w) -> (-z, -y, -x, w)
        plain = OnnxPoseNetwork(onnx_files["port"], device="cpu")(torch.from_numpy(x))["pose"].numpy()
        np.testing.assert_array_equal(got["pose"].numpy(), np.stack([-plain[:, 2], -plain[:, 1], -plain[:, 0],
                                                                     plain[:, 3]], -1))


def test_input_dims_of_the_graph(tmp_path):
    """A fixed batch of one runs frame by frame; the resolution comes from
    the graph, 129 where it is symbolic or implausible."""
    def write(name, x_shape):
        blob = _graph([("GlobalAveragePool", ["x"], {}), ("Flatten", ["t0"], {"axis": 1}),
                       ("Concat", ["t1", "t1", "t1", "t1"], {"axis": 1})], {}, x_shape=x_shape, y_shape=(1, 4),
                      y="quat")  # an opentrack name
        path = tmp_path / name
        path.write_bytes(blob)
        return str(path)

    x = torch.from_numpy(np.random.RandomState(3).rand(3, 64, 64, 1).astype(np.float32))
    single = OnnxPoseNetwork(write("one.onnx", (1, 1, 64, 64)), device="cpu")
    assert single._single_frame and single.input_resolution == 64 and single.output_names == ["pose"]
    pose = single(x)["pose"]
    np.testing.assert_allclose(pose.numpy(), np.repeat(x.numpy().mean(axis=(1, 2)), 4, axis=1), rtol=1e-6)
    symbolic = OnnxPoseNetwork(write("sym.onnx", ("batch", 1, "h", "w")), device="cpu")
    raw = OnnxPoseNetwork(write("raw.onnx", ("batch", 1, -1, -1)), device="cpu")
    assert not symbolic._single_frame and symbolic.input_resolution == raw.input_resolution == 129
    torch.testing.assert_close(symbolic(x)["pose"], pose, rtol=0, atol=0)


def test_evaluate_row_of_a_full_file_matches_jax_script(onnx_files, synthetic_set, monkeypatch):  # noqa: F811
    datadir, samples = synthetic_set
    path = onnx_files["port"]
    jbuilder = _jax_report_row(datadir, path, monkeypatch)
    (ref,) = jbuilder._entries_by_model[path]
    builder = TableBuilder()
    predictor = Predictor(load_pose_network(path, device="cpu"), RoiConfig().expansion_factor, device="cpu")
    row = add_report_row(builder, predictor, samples, path, "aflw2k3d", RoiConfig(), chunksize=128)
    assert builder._header == jbuilder._header and row[0] == ref[0]
    np.testing.assert_allclose(np.asarray(row[1:], np.float64), np.asarray(ref[1:], np.float64), rtol=0, atol=1e-3)
    assert np.isfinite(row[1:10]).all()
