"""The port's paper-reproduction protocol (`scripts/reproduce_paper.py`),
rehearsed on the CPU (`--device cpu`) at a small size, each step a child
process as on the card. On the synthetic AFLW2000-3D and 300W-LP zips of
`tests/test_torch_converters.py`, with `EPOCHS=1` and
`EXTRA_TRAIN_FLAGS="--samples-per-epoch 128 --batchsize 16"` (as the JAX
package's `tests/test_reproduce_paper.py` runs its shell script), it exits
0, prints the shell script's `==== step` lines, and its
`aflw2k3d_results.json` row is the one `eval/report.py:add_report_row`
gives for the checkpoint it wrote (as `tests/test_torch_cli.py` holds the
eval CLI). A failing child's exit code comes back and no later step runs; a
missing required variable ends the run with 1.

The file takes about 50 s alone on one CPU process, most of it the
children's start-up and the full-width network's CPU steps.
"""

import json
import os

import numpy as np
import pytest

from neuralnet_tracker_traincode_torch.scripts import convergence_band as band_cli
from neuralnet_tracker_traincode_torch.scripts import reproduce_paper as repro_cli
from tests import torch_port_helpers as H
from tests.torch_port_helpers import two_intra_op_threads  # noqa: F401 - autouse

NETWORK = "NetworkWithPointHead_mobilenetv1"
VARIABLES = ("DATADIR", "AFLW2000_ZIP", "W300LP_ZIP", "BIWI_ZIP", "BIWI_ANN", "EPOCHS", "CKPT", "DS",
             "EXTRA_TRAIN_FLAGS")


@pytest.fixture
def protocol_env(monkeypatch):
    """None of the protocol's variables from outside; the children light on the CPU."""
    for k in VARIABLES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NUM_WORKERS", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    return monkeypatch


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    from tests.test_converters import _make_zip

    d = tmp_path_factory.mktemp("archives")
    return H.make_aflw2k_zip(d), _make_zip(str(d / "300wlp.zip"))


def test_reproduce_paper_rehearsal(archives, tmp_path, protocol_env, capfd):
    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.eval.predictor import Predictor
    from neuralnet_tracker_traincode_torch.eval.report import TableBuilder, add_report_row

    datadir = tmp_path / "data"
    aflw, w300lp = archives
    for k, v in dict(DATADIR=str(datadir), AFLW2000_ZIP=aflw, W300LP_ZIP=w300lp, EPOCHS="1",
                     EXTRA_TRAIN_FLAGS="--samples-per-epoch 128 --batchsize 16").items():
        protocol_env.setenv(k, v)
    assert repro_cli.main(["--device", "cpu"]) == 0
    steps = [line for line in capfd.readouterr().out.splitlines() if line.startswith("==== ")]
    assert steps == ["==== convert AFLW2000-3D", "==== convert 300W-LP",
                     "==== train baseline (MobileNetV1 + NLL + SWA, 1 epochs)", "==== AFLW2000-3D benchmark",
                     f"==== done — tables in {datadir}/{{aflw2k3d,biwi}}_results.json"]
    run = datadir / "run" / NETWORK
    assert sorted(os.listdir(run)) == ["best.ckpt", "last.ckpt", "resume.pt", "swa.ckpt", "train.pdf"]
    (got,) = json.loads((datadir / "aflw2k3d_results.json").read_text()).values()
    ckpt = str(run / "swa.ckpt")
    protocol_env.setenv("DATADIR", str(datadir))
    builder = TableBuilder()
    want = add_report_row(builder, Predictor(ckpt, 1.1, device="cpu"), pipelines.make_validation_loader("aflw2k3d"),
                          ckpt, "aflw2k3d")
    np.testing.assert_equal([got[h][0] for h in builder._header], want)  # nan where no sample falls in a yaw bin
    assert not os.path.exists(datadir / "biwi_results.json")

    # a second run with CKPT given converts nothing, trains nothing and evaluates the file
    protocol_env.setenv("CKPT", str(run / "best.ckpt"))
    assert repro_cli.main(["--device", "cpu"]) == 0
    steps = [line for line in capfd.readouterr().out.splitlines() if line.startswith("==== ")]
    assert steps[0] == "==== AFLW2000-3D benchmark" and len(steps) == 2


def test_reproduce_paper_stops_at_a_failing_child(tmp_path, protocol_env, capfd):
    """The converter's own exit code for a missing archive, and nothing after it."""
    datadir = tmp_path / "data"
    protocol_env.setenv("DATADIR", str(datadir))
    missing = str(tmp_path / "missing.zip")
    want = band_cli.run_child("dsprocess_aflw2k", [missing, str(tmp_path / "direct.h5")], band_cli.child_env(str(datadir)))
    assert want != 0
    protocol_env.setenv("AFLW2000_ZIP", missing)
    protocol_env.setenv("W300LP_ZIP", missing)
    assert repro_cli.main(["--device", "cpu"]) == want
    steps = [line for line in capfd.readouterr().out.splitlines() if line.startswith("==== ")]
    assert steps == ["==== convert AFLW2000-3D"]
    # any child's code, from the step where it fails
    calls = []

    def fake_child(cli, args, env):
        calls.append(cli)
        return 7 if cli == "train_poseestimator" else 0

    protocol_env.setattr(repro_cli, "run_child", fake_child)
    assert repro_cli.main(["--device", "cpu"]) == 7
    assert calls == ["dsprocess_aflw2k", "dsprocess_300wlp", "train_poseestimator"]


def test_reproduce_paper_needs_its_variables(tmp_path, protocol_env, capfd):
    assert repro_cli.main(["--device", "cpu"]) == 1  # no DATADIR
    protocol_env.setenv("DATADIR", str(tmp_path / "data"))
    assert repro_cli.main([]) == 1  # no AFLW2000_ZIP, before any child runs
    err = capfd.readouterr().err
    assert "set DATADIR" in err and "AFLW2000_ZIP" in err
