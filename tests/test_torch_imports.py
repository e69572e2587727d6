"""The port stands alone: none of its modules, nor `chip_smoke.py`, imports
JAX, flax, optax, msgpack, onnx, onnxruntime or the JAX package (parsed, not
executed: the export writes and runs ONNX files with its own code), and
nothing on its import path needs triton, h5py, cv2, sklearn, pyrender,
trimesh or matplotlib, which the machine with the card may lack: those are
imported inside the functions that use them (matplotlib only where a figure
is drawn). Its data files are its own copies, and the shape prior loads
from its npz."""

import ast
import filecmp
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "neuralnet_tracker_traincode_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "onnx", "onnxruntime", "neuralnet_tracker_traincode_tpu"}
NOT_AT_IMPORT = {"triton", "h5py", "cv2", "sklearn", "pyrender", "trimesh", "matplotlib"}


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _imports(tree):
    """(root module, at module level?) of every import statement."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            yield n.split(".")[0], id(node) in top


@pytest.mark.parametrize("path", _sources())
def test_port_module_imports_nothing_of_jax(path):
    """(Nor onnx and onnxruntime, in the export modules and everywhere else.)"""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    found = list(_imports(tree))
    assert not {m for m, _ in found} & FORBIDDEN, path
    assert not {m for m, top in found if top} & NOT_AT_IMPORT, path


def test_port_has_its_own_copy_of_the_keypoint_model():
    rel = os.path.join("facemodel", "assets", "bfm_keypoints_subset.npz")
    ours = os.path.join(PORT, rel)
    assert filecmp.cmp(ours, os.path.join(ROOT, "neuralnet_tracker_traincode_tpu", rel), shallow=False)


def test_the_shape_prior_loads_without_h5py(monkeypatch):
    """`ShapePlausibilityLoss.from_npz` and the loss setup need no h5py."""
    import sys

    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.losses.losses import ShapePlausibilityLoss
    from neuralnet_tracker_traincode_torch.train.run import LossOptions, setup_losses

    monkeypatch.setitem(sys.modules, "h5py", None)  # any import of h5py now raises
    assert ShapePlausibilityLoss.from_npz().gmm.n_components == 2
    crit = setup_losses(LossOptions(), [Tag.POSE_WITH_LANDMARKS])
    assert "nll_shp_gmm" in [term.name for term in crit.terms]


_WITHOUT_H5PY_AND_CV2 = """
import importlib, os, pkgutil, sys
for name in ("h5py", "cv2", "sklearn", "pyrender", "trimesh", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises
sys.path.insert(0, {root!r})
import neuralnet_tracker_traincode_torch as port
target = {target!r}
if target == "package":
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    print("imported", len(names))
else:
    cli = importlib.import_module("neuralnet_tracker_traincode_torch.scripts." + target)
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
    print("help")
"""

CLIS = ["train_poseestimator", "evaluate_pose_network", "train_localizer", "evaluate_localizer", "export_model",
        "add_pose_pseudolabels", "fit_face_model", "evaluate_stability", "show_train_test_splits", "bench_loader"]
HOST_CLIS = ["fit_shapeparams_gmm", "make_bfm_fallback", "convert_bfm", "show_face_model"]  # no device, no --device


def test_the_export_and_cli_modules_are_covered():
    for name in ("onnx_proto", "onnx_conformance", "onnx_run", "onnx_export"):
        assert os.path.join("neuralnet_tracker_traincode_torch", "export", name + ".py") in _sources()
    for name in CLIS + HOST_CLIS:
        assert os.path.join("neuralnet_tracker_traincode_torch", "scripts", name + ".py") in _sources()


@pytest.mark.parametrize("target", ["package"] + CLIS + HOST_CLIS)
def test_the_package_and_the_cli_help_load_without_h5py_and_cv2(target):
    """Every module of the port imports, and each CLI prints its `--help`,
    on a machine without h5py, cv2, sklearn, pyrender, trimesh and
    matplotlib (as the card's may be)."""
    import subprocess
    import sys

    code = _WITHOUT_H5PY_AND_CV2.format(root=ROOT, target=target)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    if target == "package":
        assert int(res.stdout.split("imported")[-1]) >= 60
    else:
        assert "usage:" in res.stdout and ("--device" in res.stdout) == (target in CLIS)
