"""`scripts/evaluate_stability.py` of the port against the JAX package's, on
the CPU: `utils.as_hpb` / `from_hpb`, the blink-window report, and each of
the six modes through both CLIs (the JAX script loaded from its file) on a
`$DATADIR` of marker frames written by the JAX package's writer, with one
network (MobileNetV1 x0.25, point and NLL heads, random weights written by
the JAX package's `models/io` and read by both).

The network's quaternion head has its bias set to the identity, so that its
predictions lie within 90 degrees of it: the variation analysis averages
each individual's rotations with `eval/alignment.py:compute_mean_rotation`,
which keeps only rotations inside that ball and raises (in both packages)
when none is (`test_the_mean_rotation_needs_a_rotation_within_90_degrees`).

Tolerances (the eval's, `tests/test_torch_eval.py`): the figures' data,
angles within 0.025 degrees (what a quaternion within 1e-4 per component
can move an angle: 2 * 2e-4 rad), positions and sizes within 1e-3 px;
`noise_resist.pkl` within 1e-4 rad; the printed numbers within one unit of
their last printed digit, the rest of the printed text equal; the same file
names in `--outdir`. The blink report: its lines equal to the JAX
function's, its numbers within 1e-12 of a loop over the windows.
"""

import functools
import importlib.util
import os
import pickle
import re

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from neuralnet_tracker_traincode_torch import utils as T_utils
from neuralnet_tracker_traincode_torch.scripts import evaluate_stability as T

from torch_port_helpers import SMALL_NET, jax_posenet_variables, two_intra_op_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SAMPLES = "12"
DEG, PX = 0.025, 1e-3
# the tolerance of each axis of each mode's figure, in the units it plots
AXES_TOL = {"open-loop": [DEG, PX, PX], "closed-loop": [DEG, PX, PX], "pitch-yaw": [DEG, DEG],
            "noise-resist": [DEG], "uncertainty-correlation": [DEG], "variation-resist": [DEG]}


@functools.cache
def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_evaluate_stability",
                                                  os.path.join(ROOT, "scripts", "evaluate_stability.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_as_hpb_and_from_hpb_are_the_jax_ones():
    from neuralnet_tracker_traincode_tpu import utils as J_utils

    rots = Rotation.random(64, random_state=np.random.RandomState(0))
    np.testing.assert_array_equal(T_utils.as_hpb(rots), J_utils.as_hpb(rots))
    hpb = np.random.RandomState(1).uniform(-1.5, 1.5, (64, 3))
    np.testing.assert_array_equal(T_utils.from_hpb(hpb).as_quat(), J_utils.from_hpb(hpb).as_quat())
    np.testing.assert_allclose(T_utils.as_hpb(T_utils.from_hpb(hpb)), hpb, atol=1e-12)


def test_the_blink_report_is_the_jax_one(capsys):
    """2,100 frames (every window fits), two runs: the JAX function's lines,
    and numbers within 1e-12 of a loop over the windows' edges."""
    rng = np.random.RandomState(3)
    runs = [T.Poses(hpb=rng.uniform(-1, 1, (2100, 3)), xy=rng.uniform(0, 200, (2100, 2)),
                    sz=rng.uniform(20, 60, 2100)) for _ in range(2)]
    _jax_script().report_blink_stability([_jax_script().Poses(*p) for p in runs])
    want = capsys.readouterr().out
    got = T.report_blink_stability(runs)
    assert capsys.readouterr().out == want and want.count("\t ") == 3
    edges = [e for a, b in T.BLINKS for e in (a, b)]
    for name, scale in (("hpb", 180.0 / np.pi), ("sz", 1.0), ("xy", 1.0)):
        per_run = []
        for p in runs:
            vals = np.atleast_2d(getattr(p, name).T).T
            per_run.append([np.sqrt(sum((vals[e - 5, c] - vals[e + 5, c]) ** 2 for e in edges) / len(edges))
                            for c in range(vals.shape[1])])
        np.testing.assert_allclose(got[name], np.mean(per_run, axis=0) * scale, rtol=0, atol=1e-12)
    short = [p._replace(hpb=p.hpb[:200], xy=p.xy[:200], sz=p.sz[:200]) for p in runs]  # the first window only
    first = [np.sqrt(np.mean(np.square(p.sz[[85, 105]] - p.sz[[95, 115]]))) for p in short]
    np.testing.assert_allclose(T.blink_stability(short)["sz"], np.mean(first), rtol=0, atol=1e-12)
    assert T.report_blink_stability([p._replace(hpb=p.hpb[:50]) for p in runs]) is None
    assert "too short" in capsys.readouterr().out


def test_the_mean_rotation_needs_a_rotation_within_90_degrees():
    """The reference's Karcher mean keeps the rotations inside the pi/2 ball
    and starts from the first; with none it raises, in both packages."""
    from neuralnet_tracker_traincode_torch.eval.alignment import compute_mean_rotation
    from neuralnet_tracker_traincode_tpu.eval.alignment import compute_mean_rotation as jax_mean

    far = Rotation.from_rotvec(np.asarray([[2.0, 0, 0], [0, 2.1, 0]]))
    for fn in (compute_mean_rotation, jax_mean):
        with pytest.raises(IndexError):
            fn(far)
    near = Rotation.from_rotvec(np.random.RandomState(4).randn(8, 3) * 0.2)
    np.testing.assert_array_equal(compute_mean_rotation(near).as_quat(), jax_mean(near).as_quat())


def test_without_matplotlib_main_stops_before_any_model_is_loaded(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # any import of it now raises
    with pytest.raises(ImportError, match="draws its figures with matplotlib"):
        T.main(["open-loop", str(tmp_path / "absent.ckpt"), "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def stability_setup(tmp_path_factory):
    """A `$DATADIR` of the files the six modes read, and the network file."""
    from neuralnet_tracker_traincode_tpu.data.synthetic import write_synthetic_pose_dataset
    from neuralnet_tracker_traincode_tpu.models.io import save_model

    d = tmp_path_factory.mktemp("stability_data")
    write_synthetic_pose_dataset(str(d / "myself.h5"), 12, 64, seed=1)
    write_synthetic_pose_dataset(str(d / "myself-yaw.h5"), 12, 64, seed=2)
    write_synthetic_pose_dataset(str(d / "biwi-v3.h5"), 160, 48, seed=3)  # the first section starts at 145
    write_synthetic_pose_dataset(str(d / "aflw2k.h5"), 16, 64, seed=4)
    write_synthetic_pose_dataset(str(d / "replicant-face-stability-test-wider.h5"), 12, 64, seed=5,
                                 sequence_starts=[0, 3, 6, 9, 12])  # 4 individuals
    model, variables = jax_posenet_variables(21, **SMALL_NET)
    variables["params"]["quatnet"]["linear"]["bias"] = np.asarray([0, 0, 0, 1], np.float32)
    ckpt = str(d / "net.ckpt")
    save_model(model, variables, ckpt)
    return str(d), ckpt


def _figure_data(fig):
    """Each axis's artists' data: lines' (x, y), scatters' offsets, error bars' segments."""
    axes = []
    for ax in fig.axes:
        data = [np.asarray(line.get_xydata()) for line in ax.get_lines()]
        for coll in ax.collections:
            data.append(np.asarray(coll.get_segments() if hasattr(coll, "get_segments") else coll.get_offsets()))
        axes.append(data)
    return axes


def _run(main, argv, capsys, monkeypatch):
    """main(argv) with the figures it makes kept: (stdout, their data)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot

    figs, subplots = [], pyplot.subplots

    def keep(*args, **kwargs):
        fig, axes = subplots(*args, **kwargs)
        figs.append(fig)
        return fig, axes

    monkeypatch.setattr(pyplot, "subplots", keep)
    saved = np.seterr()  # the JAX script sets all="raise" for the process
    try:
        main(argv)
    finally:
        np.seterr(**saved)
        monkeypatch.undo()
    data = [_figure_data(f) for f in figs]
    for f in figs:
        pyplot.close(f)
    return capsys.readouterr().out, data


_NUMBER = re.compile(r"-?\d+\.(\d+)")


def _check_printed(got: str, want: str):
    """Equal text; numbers within one unit of their last printed digit."""
    assert _NUMBER.sub("#", got) == _NUMBER.sub("#", want), (got, want)
    for g, w in zip(_NUMBER.finditer(got), _NUMBER.finditer(want)):
        assert abs(float(g.group()) - float(w.group())) <= 1.01 * 10.0 ** -len(w.group(1)), (g.group(), w.group())


@pytest.mark.parametrize("mode", list(T.DISPATCH))
def test_each_mode_matches_the_jax_script(mode, stability_setup, tmp_path, capsys, monkeypatch):
    datadir, ckpt = stability_setup
    monkeypatch.setenv("DATADIR", datadir)
    monkeypatch.delenv("BFM_PATH", raising=False)
    outs = {k: str(tmp_path / k) for k in ("jax", "port")}
    want, want_figs = _run(_jax_script().main, [mode, ckpt, "--outdir", outs["jax"], "--max-samples", MAX_SAMPLES],
                           capsys, monkeypatch)
    monkeypatch.setenv("DATADIR", datadir)
    monkeypatch.delenv("BFM_PATH", raising=False)
    got, got_figs = _run(T.main, [mode, ckpt, "--outdir", outs["port"], "--max-samples", MAX_SAMPLES, "--device",
                                  "cpu"], capsys, monkeypatch)
    _check_printed(got.replace(outs["port"], "OUT"), want.replace(outs["jax"], "OUT"))
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"]))
    assert len(got_figs) == len(want_figs) == (2 if mode.endswith("loop") else 1)
    for got_axes, want_axes in zip(got_figs, want_figs):
        assert len(got_axes) == len(want_axes) == len(AXES_TOL[mode])
        for tol, g_artists, w_artists in zip(AXES_TOL[mode], got_axes, want_axes):
            assert len(g_artists) == len(w_artists) > 0
            for g, w in zip(g_artists, w_artists):
                assert g.shape == w.shape and np.isfinite(g).all()
                np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    if mode == "noise-resist":
        with open(os.path.join(outs["port"], "noise_resist.pkl"), "rb") as f:
            levels, by_level = pickle.load(f)
        with open(os.path.join(outs["jax"], "noise_resist.pkl"), "rb") as f:
            jlevels, jby_level = pickle.load(f)
        assert levels == jlevels == list(T.NOISE_LEVELS) and by_level.keys() == jby_level.keys()
        for level in levels:
            assert all(isinstance(v, float) for v in by_level[level])
            np.testing.assert_allclose(by_level[level], jby_level[level], rtol=0, atol=1e-4)


def test_the_analyses_agree_with_each_other(stability_setup, monkeypatch):
    """Two routes to one number: noise-resist at sigma 0 is `Predictor.evaluate`
    with `GeodesicError` on the same frames; open-loop and closed-loop agree
    on frame 0, which both crop at its ground-truth ROI; the uncertainty's
    covariance is positive definite."""
    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.eval import metrics as M
    from neuralnet_tracker_traincode_torch.eval.predictor import Predictor

    datadir, ckpt = stability_setup
    monkeypatch.setenv("DATADIR", datadir)
    predictor = Predictor(ckpt, 1.2, device="cpu")
    samples = list(pipelines.make_validation_loader("aflw2k3d", use_head_roi=True))
    with np.errstate(all="raise"):
        errors = T.noise_resist(predictor, samples, [0.0, 8.0], np.random.RandomState(T.NOISE_SEED))
        np.testing.assert_allclose(errors[0], predictor.evaluate(M.GeodesicError(), samples), rtol=0, atol=1e-6)
        assert errors.shape == (2, len(samples)) and not np.array_equal(errors[0], errors[1])
        video = list(pipelines.make_validation_loader("myself"))
        open_loop, closed_loop = T.open_loop_tracking(predictor, video), T.closed_loop_tracking(predictor, video)
        for a, b in zip(open_loop, closed_loop):
            np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)
        rot_err, uncertainty, corr = T.uncertainty_error_correlation(predictor, samples)
        assert rot_err.shape == uncertainty.shape == (len(samples),) and np.all(uncertainty > 0)
        assert -1.0 <= corr <= 1.0

        class ConstantUncertainty:  # where the JAX script's np.corrcoef raises under np.seterr(all="raise")
            def evaluate(self, metric, loader):
                return {"pose": np.linspace(0.1, 0.5, 4), "pose_scales_tril": np.tile(np.eye(3), (4, 1, 1))}

        assert np.isnan(T.uncertainty_error_correlation(ConstantUncertainty(), None)[2])
