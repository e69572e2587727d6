"""The port's dataset converters against the JAX package's scripts on the
same synthetic sources: each writes its file (or calls the stubbed external
package) through both, and the two files must hold the same groups and
datasets with the same dtypes, shapes, attributes and bit-equal values.

The sources are those of the JAX package's converter tests
(tests/test_converters.py, test_panoptic.py, test_hdf5_utilities.py,
test_bfm_gated.py): the functions that make them at module level there
are imported, the ones those tests make inline are in
`tests/torch_port_helpers.py`. The LocalizerNet ROI
refiner runs one JAX-written file in both packages on the CPU: raw outputs
within 1e-4, and equal decisions wherever the face probability is more
than that from the 0.5 threshold.
"""

import importlib
import os
import sys
import types

import numpy as np
import pytest

from tests import torch_port_helpers as H
from tests.torch_port_helpers import two_intra_op_threads  # noqa: F401 (autouse)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)


def _jax(name):
    return importlib.import_module(name)


def _port(name):
    return importlib.import_module(f"neuralnet_tracker_traincode_torch.scripts.{name}")


def _both(tmp_path, run, name="out.h5"):
    """Run `run(module, out_path)` with the JAX script's module and the
    port's, each into its own directory; the two output paths."""
    outs = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        run(pkg, str(d / name))
        outs.append(str(d / name))
    return outs


def _module(pkg, name):
    return _jax(name) if pkg == "jax" else _port(name)


def _300wlp(tmp_path, monkeypatch):
    from tests.test_converters import _make_zip

    src = _make_zip(str(tmp_path / "300wlp.zip"))
    return _both(tmp_path, lambda pkg, out: _module(pkg, "dsprocess_300wlp").generate_hdf5_dataset(
        src, out, count=None, subset="both", full_face_bounding_box=False))


def _aflw2k(tmp_path, monkeypatch):
    src = H.make_aflw2k_zip(tmp_path)
    return _both(tmp_path, lambda pkg, out: _module(pkg, "dsprocess_aflw2k").generate_hdf5_dataset(src, out))


def _wflw(tmp_path, monkeypatch):
    src = H.make_wflw_tree(tmp_path)
    pairs = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        _module(pkg, "dsprocess_wflw").generate_hdf5_dataset(src, str(d), count=None)
        pairs.append([str(d / f"wflw_{split}.h5") for split in ("train", "test")])
    return list(zip(*pairs))


def _lapa(tmp_path, monkeypatch):
    import h5py

    src = H.make_lapa_tree(tmp_path)

    def run(pkg, out):
        with h5py.File(out, "w") as f:
            _module(pkg, "dsprocess_lapa").do_conversion(src, f, None, only_megaface=True, refiner=None)

    return _both(tmp_path, run)


def _300vw(tmp_path, monkeypatch):
    import zipfile

    import h5py

    src = H.make_300vw_zip(tmp_path)
    if src is None:
        pytest.skip("cv2 VideoWriter lacks MJPG support")

    def run(pkg, out):
        mod = _module(pkg, "dsprocess_300vw")
        with zipfile.ZipFile(src) as zf, h5py.File(out, "w") as f:
            mod.do_conversion(zf, list(mod.discover_items(zf).values()), f, refiner=None)

    return _both(tmp_path, run)


def _biwi(opal):
    def case(tmp_path, monkeypatch):
        src, ann = H.make_biwi_zip(tmp_path)
        return _both(tmp_path, lambda pkg, out: _module(pkg, "dsprocess_biwi").generate_hdf5_dataset(
            src, out, opal_annotation=ann if opal else None, localizer=None))

    return case


def _unlabeled(tmp_path, monkeypatch):
    from pathlib import Path

    src = Path(H.make_unlabeled_image_dir(tmp_path))
    return _both(tmp_path, lambda pkg, out: _module(pkg, "dsprocess_unlabeled_images").convert_unlabeled_sequences(
        src, out, None, None))


def _argv_main(name, *argv):
    def run(pkg, out):
        mod = _module(pkg, name)
        if pkg == "jax":
            sys.argv = [name + ".py", *argv, out]
            mod.main()
        else:
            assert mod.main([*argv, out]) == 0

    return run


def _synface(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    return _both(tmp_path, _argv_main("dsprocess_synface", H.make_synface_zip(tmp_path)))


def _widerface(tmp_path, monkeypatch):
    src = H.make_widerface_dir(tmp_path)
    return _both(tmp_path, lambda pkg, out: _module(pkg, "dsprocess_widerface").generate_hdf5_dataset(
        src, out, count=None, maxsize=640))


def _replicantface(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    return _both(tmp_path, _argv_main("dsprocess_replicantface", H.make_replicantface_tree(tmp_path)))


def _panoptic(tmp_path, monkeypatch):
    from tests.test_panoptic import _make_sequence

    seq, video_ok = _make_sequence(tmp_path)
    if not video_ok:
        pytest.skip("cv2 VideoWriter lacks mp4v support in this build")
    monkeypatch.delenv("BFM_PATH", raising=False)
    return _both(tmp_path, lambda pkg, out: _module(pkg, "dsprocess_panoptic").write_dataset_piece(out, seq, cam_id=0))


def _dsjoin(tmp_path, monkeypatch):
    import h5py

    from tests.test_hdf5_utilities import _write

    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    _write(a, 6, seq_starts=[0, 2, 6], seed=1)
    _write(b, 4, seq_starts=[0, 3, 4], seed=2)

    def run(pkg, out):
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb, h5py.File(out, "w") as fo:
            _module(pkg, "dsjoin").dsjoin([fa, fb], fo)

    return _both(tmp_path, run)


def _filter(by_frames):
    def case(tmp_path, monkeypatch):
        import h5py

        from tests.test_hdf5_utilities import _write

        src = str(tmp_path / "src.h5")
        _write(src, 6, seq_starts=None if by_frames else [0, 2, 3, 6], seed=3)

        def run(pkg, out):
            mod = _module(pkg, "filter_dataset")
            with h5py.File(src, "r") as f, h5py.File(out, "w") as fo:
                if by_frames:
                    mod.filter_file_by_frames(f, fo, bad_frame_indices=[0, 3])
                else:
                    mod.filter_file_by_sequences(f, fo, bad_sequence_indices=[1])

        return _both(tmp_path, run)

    return case


CASES = {
    "dsprocess_300wlp": _300wlp,
    "dsprocess_aflw2k": _aflw2k,
    "dsprocess_wflw": _wflw,
    "dsprocess_lapa": _lapa,
    "dsprocess_300vw": _300vw,
    "dsprocess_biwi_opal": _biwi(True),
    "dsprocess_biwi_projected": _biwi(False),
    "dsprocess_unlabeled_images": _unlabeled,
    "dsprocess_synface": _synface,
    "dsprocess_widerface": _widerface,
    "dsprocess_replicantface": _replicantface,
    "dsprocess_panoptic": _panoptic,
    "dsjoin": _dsjoin,
    "filter_by_sequences": _filter(False),
    "filter_by_frames": _filter(True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_writes_the_jax_file(case, tmp_path, monkeypatch):
    outs = CASES[case](tmp_path, monkeypatch)
    pairs = outs if isinstance(outs[0], tuple) else [tuple(outs)]
    for a, b in pairs:
        H.assert_h5_files_equal(a, b)


def test_closed_eyes_wrapper_calls_the_package_as_the_jax_script_does(monkeypatch, tmp_path):
    calls = {}
    for pkg in ("jax", "port"):
        written, passthrough = [], []
        H.stub_closed_eyes_package(monkeypatch, written, passthrough)
        mod = _module(pkg, "create_aflw2k3d_closed_eyes")
        run = mod.main if pkg == "jax" else mod.convert
        run("in.zip", str(tmp_path / "out.h5"), 2, prob_closed_eyes=0.5)
        calls[pkg] = (written, passthrough)
    assert calls["port"] == calls["jax"]
    assert [n for n, _ in calls["port"][0]] == ["a", "b"] and calls["port"][1] == ["b"]


def test_closed_eyes_wrapper_exits_without_the_package(monkeypatch):
    for name in list(sys.modules):
        if name.startswith("face3drotationaugmentation"):
            monkeypatch.delitem(sys.modules, name)
    messages = []
    for pkg in ("jax", "port"):
        mod = _module(pkg, "create_aflw2k3d_closed_eyes")
        with pytest.raises(SystemExit, match="face3drotationaugmentation") as e:
            (mod.main if pkg == "jax" else mod.convert)("in.zip", "out.h5", 1, 0.0)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_largepose_wrapper_calls_the_package_as_the_jax_script_does(monkeypatch, tmp_path):
    """Frame selection, the promoted fit group and every sample handed to the
    stubbed package equal the JAX script's; the temporary files go."""
    from tests.test_bfm_gated import _stub_rotaug_package

    path = H.write_fitted_pose_file(tmp_path / "fitted.h5")
    bad_file = tmp_path / "bad.json"
    bad_file.write_text("[4]")
    calls = {}
    for pkg in ("jax", "port"):
        written, augment_calls = [], []
        _stub_rotaug_package(monkeypatch, written, augment_calls)
        _module(pkg, "create_largepose_dataset").main(
            [path, str(tmp_path / f"{pkg}.h5"), "--bad-frames", str(bad_file), "--angle-step", "7.5"])
        calls[pkg] = (written, augment_calls)
    assert calls["port"][0] == calls["jax"][0] and [n for n, _ in calls["port"][0]] == ["sample00"] * 2 + [
        "sample01"] * 2
    assert len(calls["port"][1]) == len(calls["jax"][1]) == 2
    for got, want in zip(calls["port"][1], calls["jax"][1]):
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "rot":
                np.testing.assert_array_equal(got[k].as_quat(), want[k].as_quat())
            else:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bad.json", "fitted.h5"]


def test_largepose_wrapper_exits_as_the_jax_script_does(monkeypatch, tmp_path):
    path = H.write_fitted_pose_file(tmp_path / "fitted.h5")
    for name in list(sys.modules):
        if name.startswith("face3drotationaugmentation"):
            monkeypatch.delitem(sys.modules, name)
    for argv, match in (([], "face3drotationaugmentation"), (["--min-diameter", "1e9"], "empty")):
        messages = []
        for pkg in ("jax", "port"):
            with pytest.raises(SystemExit, match=match) as e:
                _module(pkg, "create_largepose_dataset").main([path, str(tmp_path / "aug.h5"), *argv])
            messages.append(str(e.value))
        assert messages[0] == messages[1]


# ---- the LocalizerNet ROI refiner --------------------------------------------------------


def _refiner_images():
    """Images of several sizes and kinds: noise, smooth blobs, gradients,
    colour and grayscale."""
    import cv2

    rng = np.random.RandomState(21)
    out = []
    for i, (h, w) in enumerate([(280, 280), (240, 320), (300, 200), (224, 288), (180, 260), (320, 240)]):
        noise = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        out.append(noise if i % 2 == 0 else noise[..., 0])
        blob = cv2.GaussianBlur(noise, (0, 0), 9)
        out.append(cv2.normalize(blob, None, 0, 255, cv2.NORM_MINMAX))
    return out


LOGIT_GAIN = 200.0


@pytest.fixture(scope="module")
def localizer_file(tmp_path_factory):
    """(A JAX-written LocalizerNet file, the JAX network's raw outputs on
    `_refiner_images`). Its weights and statistics are perturbed and its face
    logits over the images spread LOGIT_GAIN times (a random network's
    differ by about 0.006) and centred on their median, so that half the
    images are faces and half not, none of them at the threshold."""
    import jax
    import jax.numpy as jnp

    from neuralnet_tracker_traincode_tpu.models import io as jio
    from neuralnet_tracker_traincode_torch.scripts.dsprocess_lapa import LocalizerRoiRefiner
    from tests.test_torch_localizer import jax_localizer

    model, variables = jax_localizer(seed=3)
    apply = jax.jit(model.apply)
    final = variables["params"]["final_conv"]
    x = jnp.asarray(np.concatenate([LocalizerRoiRefiner.network_input(img) for img in _refiner_images()]))
    logits = np.asarray(apply(variables, x)[:, 0]) - final["bias"][0]
    final["kernel"] = final["kernel"] * np.asarray([LOGIT_GAIN, 1.0], np.float32)
    final["bias"] = np.asarray([-LOGIT_GAIN * np.median(logits), final["bias"][1]], np.float32)
    path = str(tmp_path_factory.mktemp("localizer") / "localizer.ckpt")
    jio.save_model(model, variables, path)
    return path, np.asarray(apply(variables, x))


def test_refiner_matches_the_jax_refiner(localizer_file):
    """Raw outputs within 1e-4; the refiner's decision and refined ROI (at
    the converters' IoU thresholds 0.25 and -1, in turns) as the JAX
    refiner's, the ROI within 1e-4 of the image's size."""
    import jax

    from neuralnet_tracker_traincode_tpu.models.localizer import LocalizerNet as JLoc

    path, raw = localizer_file
    jax_refiner = _jax("dsprocess_lapa").LocalizerRoiRefiner(path)
    jax_refiner.model = types.SimpleNamespace(apply=jax.jit(jax_refiner.model.apply))  # one compile, not eager ops
    port_refiner = _port("dsprocess_lapa").LocalizerRoiRefiner(path, device="cpu")
    want = JLoc.inference_outputs(raw)
    decided = set()
    for i, img in enumerate(_refiner_images()):
        h, w = img.shape[:2]
        want_p, want_box = float(want["hasface"][i]), np.asarray(want["roi"][i])
        got_p, got_box = port_refiner.predict(img)
        assert abs(got_p - want_p) <= 1e-4 and np.abs(got_box - want_box).max() <= 1e-4, (i, got_p, want_p)
        assert abs(want_p - 0.5) > 1e-4, "an image at the threshold: no decision to compare"
        roi = np.asarray([0.2 * w, 0.2 * h, 0.8 * w, 0.8 * h], np.float32)
        threshold = (0.25, -1.0)[i % 2]
        (want_roi, want_ok), (got_roi, got_ok) = (r(img, roi, iou_threshold=threshold)
                                                  for r in (jax_refiner, port_refiner))
        assert got_ok == want_ok, i
        np.testing.assert_allclose(got_roi, want_roi, rtol=0, atol=1e-4 * max(h, w))
        decided.add((want_ok, threshold))
    assert {ok for ok, _ in decided} == {True, False} and len(decided) >= 3, decided


def test_lapa_with_the_refiner_writes_the_jax_file(localizer_file, tmp_path):
    """The conversion with `--localizer` through each package's refiner:
    equal files but for the refined ROIs and the landmarks cropped by them,
    within the refiner's 1e-4 (at most one f16 step). The ROIs are the
    refined ones, not the landmarks' own."""
    import h5py
    import jax

    src = H.make_lapa_tree(tmp_path, names=("12345", "23456", "34567"))
    outs = []
    for pkg in ("jax", "port"):
        mod = _module(pkg, "dsprocess_lapa")
        if pkg == "jax":
            refiner = mod.LocalizerRoiRefiner(localizer_file[0])
            refiner.model = types.SimpleNamespace(apply=jax.jit(refiner.model.apply))
        else:
            refiner = mod.LocalizerRoiRefiner(localizer_file[0], device="cpu")
        outs.append(str(tmp_path / f"{pkg}.h5"))
        with h5py.File(outs[-1], "w") as f:
            mod.do_conversion(src, f, None, only_megaface=True, refiner=refiner)
    with h5py.File(outs[0], "r") as a, h5py.File(outs[1], "r") as b:
        assert sorted(a) == sorted(b) and len(a["images"]) == 3
        for i in range(3):
            assert np.array_equal(a["images"][i], b["images"][i])
        for name in ("rois", "pt2d_68"):
            u, v = a[name][...], b[name][...]
            assert u.dtype == v.dtype == np.float16 and u.shape == v.shape
            step = np.spacing(np.abs(u).astype(np.float16)).astype(np.float32)
            assert np.all(np.abs(u.astype(np.float32) - v.astype(np.float32)) <= step), name
            assert dict(a[name].attrs) == dict(b[name].attrs)
        unrefined = str(tmp_path / "unrefined.h5")
        with h5py.File(unrefined, "w") as f:
            _port("dsprocess_lapa").do_conversion(src, f, None, only_megaface=True, refiner=None)
        with h5py.File(unrefined, "r") as c:
            assert not np.array_equal(c["rois"][...], b["rois"][...])
