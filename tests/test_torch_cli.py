"""The port's CLIs (`neuralnet_tracker_traincode_torch/scripts/`), run in
this process on the CPU (`--device cpu`) over a `$DATADIR` of synthetic
files at a small size.

 - `parse_dataset_definition` is the JAX script's on a table of `--ds`
   strings (the JAX script is loaded from its file; its JAX imports are
   inside `main`).
 - The pose trainer runs one epoch (with `--profile-dir`: a Chrome trace),
   then a second one with `--resume auto`; its model files load in the JAX
   package's `models/io`.
 - The pose eval CLI on the trainer's `best.ckpt` writes the row that
   `eval/report.py:add_report_row` gives for the same checkpoint and data
   (held against the JAX package by `test_torch_eval.py`), and overlays.
 - The localizer's trainer and eval CLI run on a small
   `widerfacessingle.h5`; its model file loads in the JAX package.
 - The export CLI on the trainer's `best.ckpt` (6D, point and NLL heads,
   full width), chained as the JAX package's `tests/test_cli_smoke.py`
   chains it: `--full` (byte-equal to the JAX script's file for the same
   checkpoint), `--half`, `--quantize` with `--calib-ds` on a synthetic
   `.h5` (every backbone conv int8), `--torch-checkpoint` (the JAX
   package's reference-format state dict, key for key and value for value)
   and `--localizer`; each passes its own parity check. The pose eval CLI
   on the `--full` file gives the checkpoint's row within 1e-3, and
   `add_pose_pseudolabels` on it writes the labels the JAX CLI writes from
   the same file, within 1e-4.
 - `bench_loader` at `-n 64` with `--raw`: every stage, the loader in
   both JPEG decode modes; with `--memory noise --ab` (no file) the pack
   stage in turns; its training stage at K = 2 for one group, its first
   group equal to the host decode's batches.
 - The figure paths: the trainer writes its loss plot `train.pdf`; where
   matplotlib does not import, `--plot-save-filename` raises before any data
   is read and a run without it says that it writes no plot; the eval CLI's
   `--vis` without `--vis-outdir` pages through the overlays that
   `--vis-outdir` writes.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from neuralnet_tracker_traincode_torch.scripts import add_pose_pseudolabels as pseudo_cli
from neuralnet_tracker_traincode_torch.scripts import bench_loader as bench_loader_cli
from neuralnet_tracker_traincode_torch.scripts import evaluate_localizer as eval_loc_cli
from neuralnet_tracker_traincode_torch.scripts import evaluate_pose_network as eval_cli
from neuralnet_tracker_traincode_torch.scripts import export_model as export_cli
from neuralnet_tracker_traincode_torch.scripts import train_localizer as train_loc_cli
from neuralnet_tracker_traincode_torch.scripts import train_poseestimator as train_cli

from torch_port_helpers import two_intra_op_threads  # noqa: F401 - autouse: full-width networks on the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arg", ["300wlp", "300wlp+synface:10000", "aflw2k:1000+biwi+wider:0.5",
                                 "repro_300_wlp+repro_300_wlp_woextra:3+wflw_lp", "lapa_megaface_lp+panoptic:2.5",
                                 "replicantface:7+replicantface"])
def test_parse_dataset_definition_is_the_jax_one(arg):
    ids, weights = train_cli.parse_dataset_definition(arg)
    jids, jweights = _jax_script("train_poseestimator").parse_dataset_definition(arg)
    assert sorted(i.name for i in ids) == sorted(i.name for i in jids)
    assert {k.name: v for k, v in weights.items()} == {k.name: v for k, v in jweights.items()}


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    import h5py

    from neuralnet_tracker_traincode_torch.data.dataset_writers import write_pose_hdf5
    from neuralnet_tracker_traincode_torch.data.synthetic import write_synthetic_pose_dataset

    d = tmp_path_factory.mktemp("cli_datadir")
    write_synthetic_pose_dataset(str(d / "aflw2k.h5"), 20, 64, seed=4, device="cpu")
    write_synthetic_pose_dataset(str(d / "300wlp.h5"), 24, 64, seed=3, device="cpu")
    rng = np.random.RandomState(0)

    def faces():
        for i in range(516):
            lo = rng.uniform(4, 20, 2)
            yield dict(image=(rng.rand(48, 56) * 255).astype(np.uint8), pose=np.float32([0, 0, 0, 1]),
                       coord=np.float32([28, 24, 10]), roi=np.concatenate([lo, lo + 20]).astype(np.float32),
                       hasface=np.bool_(i % 3 != 0))

    with h5py.File(d / "widerfacessingle.h5", "w") as f:
        write_pose_hdf5(f, faces(), 516, progress=False)
    return str(d)


@pytest.fixture(scope="module")
def pose_run(datadir, tmp_path_factory):
    """The pose trainer for one epoch, then one more with `--resume auto`."""
    out = str(tmp_path_factory.mktemp("pose_run"))
    mp = pytest.MonkeyPatch()
    mp.setenv("DATADIR", datadir)
    mp.setenv("NUM_WORKERS", "1")
    try:
        common = ["--ds", "300wlp", "--batchsize", "8", "--samples-per-epoch", "16", "--device", "cpu",
                  "--dtype", "float32", "--with-nll-loss", "--enable-6drot", "--seed", "0", "--outdir", out]
        assert train_cli.main(common + ["--epochs", "1", "--profile-dir", os.path.join(out, "profile")]) == 0
        first = sorted(os.listdir(os.path.join(out, "NetworkWithPointHead_mobilenetv1")))
        assert train_cli.main(common + ["--epochs", "2", "--with-swa", "--resume", "auto"]) == 0
    finally:
        mp.undo()
    return os.path.join(out, "NetworkWithPointHead_mobilenetv1"), first


def test_pose_trainer_runs_and_resumes(pose_run, capsys):
    outdir, first = pose_run
    assert first == ["best.ckpt", "last.ckpt", "resume.pt", "train.pdf"]
    with open(os.path.join(os.path.dirname(outdir), "profile", "trace.json")) as f:  # --profile-dir's trace
        assert json.load(f)["traceEvents"]
    assert sorted(os.listdir(outdir)) == ["best.ckpt", "last.ckpt", "resume.pt", "swa.ckpt", "train.pdf"]
    from neuralnet_tracker_traincode_torch.train.checkpointing import FORMAT

    with open(os.path.join(outdir, "resume.pt"), "rb") as f:
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    assert header["format"] == FORMAT and header["extra"]["epoch"] == 1  # the second run went on from epoch 1
    from neuralnet_tracker_traincode_tpu.models import io as jio

    for name in ("best.ckpt", "last.ckpt", "swa.ckpt"):
        model, variables = jio.load_posenet(os.path.join(outdir, name))
        assert model.enable_6drot and model.enable_uncertainty and "params" in variables


def test_pose_trainer_steps_per_dispatch_on_the_cpu(datadir, tmp_path, monkeypatch, capsys):
    """`--steps-per-dispatch 2` with `--device cpu` runs the K-step loop (on
    the card, one CUDA graph replay of 2 steps): its model files are the
    bytes of the one-step run's. The default on the CPU is one step."""
    monkeypatch.setenv("DATADIR", datadir)
    monkeypatch.setenv("NUM_WORKERS", "1")
    common = ["--ds", "300wlp", "--batchsize", "8", "--samples-per-epoch", "32", "--device", "cpu", "--dtype",
              "float32", "--seed", "0", "--epochs", "1"]
    for k in ("0", "2"):
        assert train_cli.main(common + ["--steps-per-dispatch", k, "--outdir", str(tmp_path / k)]) == 0
    assert "auto --steps-per-dispatch" not in capsys.readouterr().out
    for name in ("last.ckpt", "best.ckpt"):
        files = [tmp_path / k / "NetworkWithPointHead_mobilenetv1" / name for k in ("0", "2")]
        assert files[0].read_bytes() == files[1].read_bytes(), name
    assert train_cli.parse_args([]).device == eval_cli.build_parser().parse_args(["m.ckpt"]).device == "cuda"


def test_pose_eval_cli_writes_the_report_row(pose_run, datadir, tmp_path, monkeypatch):
    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.eval.predictor import Predictor
    from neuralnet_tracker_traincode_torch.eval.report import TableBuilder, add_report_row

    monkeypatch.setenv("DATADIR", datadir)
    ckpt = os.path.join(pose_run[0], "best.ckpt")
    vis = tmp_path / "vis"
    out = tmp_path / "rows.json"
    assert eval_cli.main([ckpt, "--ds", "aflw2k3d", "--json", str(out), "--vis", "kpts", "--vis-outdir", str(vis),
                          "--device", "cpu"]) == 0
    table = json.loads(out.read_text())
    (got,) = table.values()
    builder = TableBuilder()
    want = add_report_row(builder, Predictor(ckpt, 1.1, device="cpu"), pipelines.make_validation_loader("aflw2k3d"),
                          ckpt, "aflw2k3d")
    np.testing.assert_equal([got[h][0] for h in builder._header], want)  # nan where no sample falls in a yaw bin
    n = len(pipelines.make_validation_dataset("aflw2k3d"))
    assert sorted(os.listdir(vis)) == [f"worst_{i:03d}.png" for i in range(min(32, n))]
    # two ROI configurations of the sweep, and the markdown table
    assert eval_cli.main([ckpt, "--ds", f"{datadir}/aflw2k.h5", "--roi-expansion", "1.2", "--device", "cpu",
                          "--precision", "bfloat16"]) == 0


def test_localizer_clis(datadir, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DATADIR", datadir)
    assert train_loc_cli.main(["--batchsize", "8", "--epochs", "1", "--samples-per-epoch", "16", "--device", "cpu",
                               "--outdir", str(tmp_path)]) == 0
    ckpt = str(tmp_path / "LocalizerNet" / "last.ckpt")
    from neuralnet_tracker_traincode_tpu.models import io as jio
    from neuralnet_tracker_traincode_tpu.models.localizer import LocalizerNet

    model, variables = jio.load_model(ckpt, [LocalizerNet])
    assert isinstance(model, LocalizerNet) and "batch_stats" in variables
    capsys.readouterr()
    for protocol in ("full", "crop"):
        vis = tmp_path / f"vis_{protocol}"
        assert eval_loc_cli.main([ckpt, "-n", "12", "--batchsize", "8", "--protocol", protocol, "--thresholds", "0.5",
                                  "--vis-outdir", str(vis), "--device", "cpu"]) == 0
        assert sorted(os.listdir(vis)) == [f"loc_{i:03d}.png" for i in range(12)]
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("Threshold 0.5 => Acc ") for line in lines) == 2
    assert eval_loc_cli.main([ckpt, "--ds", f"{datadir}/widerfacessingle.h5", "-n", "8", "--device", "cpu"]) == 0


def test_pose_run_writes_the_loss_plot(pose_run):
    """`train.pdf` in the model directory (the JAX CLI's default), a PDF of
    the second run's histories: every train metric, the test losses and lr."""
    with open(os.path.join(pose_run[0], "train.pdf"), "rb") as f:
        blob = f.read()
    assert blob.startswith(b"%PDF") and len(blob) > 10_000


def test_without_matplotlib_the_trainer_plots_nothing(datadir, tmp_path, monkeypatch, capsys):
    """matplotlib blocked (any import of it raises), as on the card's
    machine: `--plot-save-filename` raises before any data is read, with a
    message that names matplotlib; without the flag the run says at its
    start that it writes no `train.pdf`, and trains."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delenv("DATADIR", raising=False)  # nothing is read before the refusal
    argv = ["--ds", "300wlp", "--batchsize", "8", "--samples-per-epoch", "8", "--device", "cpu", "--dtype", "float32",
            "--seed", "0", "--epochs", "1", "--outdir", str(tmp_path)]
    with pytest.raises(ImportError, match="--plot-save-filename needs matplotlib"):
        train_cli.main(argv + ["--plot-save-filename", str(tmp_path / "x.pdf")])
    monkeypatch.setenv("DATADIR", datadir)
    monkeypatch.setenv("NUM_WORKERS", "1")
    assert train_cli.main(argv) == 0
    assert capsys.readouterr().out.startswith("train.pdf will not be written: matplotlib does not import")
    assert sorted(os.listdir(tmp_path / "NetworkWithPointHead_mobilenetv1")) == ["best.ckpt", "last.ckpt", "resume.pt"]


def test_pose_eval_cli_pages_through_the_worst_cases(pose_run, datadir, tmp_path, monkeypatch):
    """`--vis rot` without `--vis-outdir` under the Agg backend, with
    `pyplot.show` patched to a no-op: the pager's first page shows the nine
    worst samples, each the image that `--vis-outdir` writes for it."""
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot

    monkeypatch.setenv("DATADIR", datadir)
    shown = []
    monkeypatch.setattr(pyplot, "show", lambda *a, **k: shown.append(pyplot.gcf()))
    ckpt = os.path.join(pose_run[0], "best.ckpt")
    assert eval_cli.main([ckpt, "--ds", "aflw2k3d", "--vis", "rot", "--device", "cpu"]) == 0
    (fig,) = shown
    assert fig._suptitle.get_text().startswith("aflw2k3d / ")
    pages = [ax.get_images()[0].get_array() for ax in fig.axes if ax.get_images()]
    assert len(pages) == 9
    vis = tmp_path / "vis"
    assert eval_cli.main([ckpt, "--ds", "aflw2k3d", "--vis", "rot", "--vis-outdir", str(vis), "--device", "cpu"]) == 0
    for i, page in enumerate(pages):
        np.testing.assert_array_equal(np.asarray(page), cv2.imread(str(vis / f"worst_{i:03d}.png"))[..., ::-1])
    pyplot.close(fig)


@pytest.fixture(scope="module")
def full_onnx(pose_run, tmp_path_factory):
    """`export_model --full` on the trainer's best.ckpt."""
    path = str(tmp_path_factory.mktemp("export") / "model_full.onnx")
    assert export_cli.main([os.path.join(pose_run[0], "best.ckpt"), "--output", path, "--full", "--device", "cpu"]) == 0
    return path


def test_export_full_is_the_jax_scripts_file(pose_run, full_onnx, tmp_path, monkeypatch):
    import sys

    ckpt = os.path.join(pose_run[0], "best.ckpt")
    theirs = str(tmp_path / "jax_full.onnx")
    monkeypatch.setattr(sys, "argv", ["export_model.py", ckpt, "--output", theirs, "--full", "--no-parity-check"])
    _jax_script("export_model").main()
    with open(full_onnx, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flags", [["--half"], ["--quantize", "--calib-samples", "16"], ["--torch-checkpoint"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_export_cli_variants(pose_run, datadir, flags, tmp_path, capsys):
    import torch

    from neuralnet_tracker_traincode_torch.export import onnx_conformance, onnx_run

    ckpt = os.path.join(pose_run[0], "best.ckpt")
    out = str(tmp_path / "m.onnx")
    argv = [ckpt, "--output", out, "--device", "cpu"] + flags
    if flags[0] == "--quantize":
        argv += ["--calib-ds", os.path.join(datadir, "aflw2k.h5")]
    if flags[0] == "--torch-checkpoint":
        argv.append(str(tmp_path / "m.pt"))
    assert export_cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "Parity check passed." in printed
    with open(out, "rb") as f:
        blob = f.read()
    onnx_conformance.validate_model(blob)
    model = onnx_run.load_model(blob)
    assert model.output_names[:3] == ["pos_size", "quat", "box"]
    if flags[0] == "--half":
        assert any(v.dtype == np.float16 for v in model.initializers.values())
    if flags[0] == "--quantize":
        assert "Calibrating on 16 samples" in printed
        assert len([v for v in model.initializers.values() if v.dtype == np.int8 and v.ndim == 4]) == 27
    if flags[0] == "--torch-checkpoint":
        from neuralnet_tracker_traincode_tpu.export.onnx_export import clear_denormals
        from neuralnet_tracker_traincode_tpu.models import io as jio
        from neuralnet_tracker_traincode_tpu.models.torch_export import export_posenet_state_dict

        saved = torch.load(str(tmp_path / "m.pt"), weights_only=False)
        jmodel, variables = jio.load_posenet(ckpt)
        want = export_posenet_state_dict(clear_denormals(variables), jmodel.get_config())
        assert saved["class_name"] == "NetworkWithPointHead" and saved["config"]["enable_6drot"]
        assert set(want) <= set(saved["state_dict"])
        for k, v in want.items():
            np.testing.assert_array_equal(saved["state_dict"][k].numpy(), v, err_msg=k)


def test_export_localizer_cli(tmp_path, capsys):
    import jax

    from neuralnet_tracker_traincode_tpu.export import onnx_export as JE
    from neuralnet_tracker_traincode_tpu.models import io as jio
    from neuralnet_tracker_traincode_tpu.models.localizer import LocalizerNet as JLoc
    from neuralnet_tracker_traincode_torch.models.io import save_model
    from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet

    import torch

    net = LocalizerNet()
    net.init_weights(torch.Generator().manual_seed(2))
    ckpt, out = str(tmp_path / "loc.ckpt"), str(tmp_path / "loc.onnx")
    save_model(net, None, ckpt)
    assert export_cli.main([ckpt, "--output", out, "--localizer", "--device", "cpu"]) == 0
    assert "Parity check passed." in capsys.readouterr().out
    jmodel, variables = jio.load_model(ckpt, [JLoc])
    with open(out, "rb") as f:
        assert f.read() == JE.build_localizer_onnx(jmodel, JE.clear_denormals(jax.tree_util.tree_map(np.asarray,
                                                                                                     variables)))


def test_pose_eval_cli_on_an_onnx_file(pose_run, full_onnx, datadir, tmp_path, monkeypatch):
    monkeypatch.setenv("DATADIR", datadir)
    rows = {}
    for name, path in (("onnx", full_onnx), ("ckpt", os.path.join(pose_run[0], "best.ckpt"))):
        out = tmp_path / f"{name}.json"
        assert eval_cli.main([path, "--ds", "aflw2k3d", "--json", str(out), "--device", "cpu"]) == 0
        (rows[name],) = json.loads(out.read_text()).values()
    assert set(rows["onnx"]) == set(rows["ckpt"]) and "NME3d%" in rows["onnx"]
    for k, v in rows["ckpt"].items():
        if isinstance(v[0], str):
            assert rows["onnx"][k] == v
        else:
            np.testing.assert_allclose(np.asarray(rows["onnx"][k], np.float64), np.asarray(v, np.float64), rtol=0,
                                       atol=1e-3, err_msg=k)


def test_pseudolabel_cli_matches_jax(full_onnx, datadir, tmp_path):
    """On a quaternion network's `--full` file (the pseudo-labels average
    `unnormalized_quat`: the trainer's 6D network's file is refused)."""
    import argparse
    import shutil

    import h5py
    import torch

    from neuralnet_tracker_traincode_torch.models.io import save_model
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from torch_port_helpers import SMALL_NET

    net = NetworkWithPointHead(**SMALL_NET)
    net.init_weights(torch.Generator().manual_seed(5))
    ckpt, quat_onnx = str(tmp_path / "quat.ckpt"), str(tmp_path / "quat_full.onnx")
    save_model(net, None, ckpt)
    assert export_cli.main([ckpt, "--output", quat_onnx, "--full", "--device", "cpu"]) == 0
    paths = {k: str(tmp_path / f"{k}.h5") for k in ("port", "jax", "6d")}
    for p in paths.values():
        shutil.copy(os.path.join(datadir, "aflw2k.h5"), p)
    with pytest.raises(ValueError, match="unnormalized_quat"):
        pseudo_cli.main([paths["6d"], "-c", full_onnx, "--device", "cpu"])
    assert pseudo_cli.main([paths["port"], "-c", quat_onnx, "-b", "8", "--overwrite", "--device", "cpu"]) == 0
    _jax_script("add_pose_pseudolabels").fitall(argparse.Namespace(
        filename=paths["jax"], checkpoints=[quat_onnx], batchsize=8, hdfgroupname="", dryrun=False, overwrite=True))
    with h5py.File(paths["port"], "r") as a, h5py.File(paths["jax"], "r") as b:
        for key, shape in (("quats", (20, 4)), ("coords", (20, 3)), ("pt3d_68", (20, 68, 3)), ("shapeparams", (20, 50))):
            ours, theirs = a[key][...], b[key][...]
            assert ours.shape == theirs.shape == shape and ours.dtype == np.float32, key
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(np.linalg.norm(a["quats"][...], axis=-1), 1.0, atol=1e-5)


def test_bench_loader_runs_every_stage_on_the_cpu(capsys):
    assert bench_loader_cli.main(["-n", "64", "--batchsize", "16", "--raw", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("h5 read:", "decode:", "host scan stage", "host entropy decode", "K5 and K4", "cv2 on the host",
                 "parse on the host, K5 and K4"):
        assert line in out, line
    assert out.count("pack:") == 2


def test_bench_loader_in_memory_frames_take_both_decodes_in_turns(capsys):
    args = ["--memory", "noise", "--size", "64", "-n", "32", "--batchsize", "8", "--ab", "--device", "cpu"]
    assert bench_loader_cli.main(args) == 0
    out = capsys.readouterr().out
    assert "h5 read:" not in out and "made:     32 noise frames at 64^2" in out and "host entropy decode" in out
    modes = [line.split("raw-jpeg batch decode, ")[1].split(",")[0] for line in out.splitlines()
             if line.startswith("pack:")]
    assert modes == ["parse on the host", "cv2 on the host", "cv2 on the host", "parse on the host"]
    with pytest.raises(SystemExit):
        bench_loader_cli.main(["--train", "--device", "cpu"])


def test_bench_loader_training_stage_runs_a_group_on_the_cpu():
    """The training stage at K = 2 for one group over one process worker
    decoding with the plain K5 and K4: its first group equals the host decode's
    first two batches of the same sampler, no kernel is launched."""
    import torch

    from neuralnet_tracker_traincode_torch.data.loader import FusedBatchLoader
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler

    cpu = torch.device("cpu")
    train = bench_loader_cli.jpeg_frames(16, 64, 3, cpu, "markers")
    val = bench_loader_cli.jpeg_frames(4, 64, 4, cpu, "markers")
    r = bench_loader_cli.training_stage(train, val, 64, cpu, "device", batchsize=4, epochs=1, samples_per_epoch=8,
                                        steps_per_dispatch=2, workers=1, alone_batches=2)
    assert r["steps"] == 2 and len(r["waits"]) == 1 and len(r["records"]) == 1 and r["alone"] > 0
    assert not any(r["launches"].values())
    assert all(np.isfinite(v) for v in r["records"][0]["train_metrics"].values()) and np.isfinite(r["losses"][1])
    concat = ConcatDataset([train])
    host = FusedBatchLoader(concat, lambda i: train.tag, {train.tag: 0},
                            make_concat_dataset_item_sampler(concat, [1.0], seed=3), 4, 64).iterate()
    for k, want in zip(range(2), host):
        for name, v in want.items():
            np.testing.assert_array_equal(r["first"][name][k].numpy(), v, err_msg=name)
    host.close()
