"""The port's convergence band (`scripts/convergence_band.py`), rehearsed
on the CPU (`--device cpu`) at a small size, each run a child process as on
the card: 2 seeds, 1 epoch, 432 frames at 64^2. `band.json` is in the shell
script's layout, one row a seed, the seeds' rows apart; `band_summary`'s
statistics; `seed_streams` gives what the training CLI uses (its sampler,
step generator and model init, read where the CLI hands them over).

The file takes about 75 s alone on one CPU process, most of it the
children's start-up and the full-width network's CPU steps.
"""

import json
import os

import numpy as np
import pytest

from neuralnet_tracker_traincode_torch.scripts import convergence_band as band_cli
from tests.torch_port_helpers import two_intra_op_threads  # noqa: F401 - autouse

NETWORK = "NetworkWithPointHead_mobilenetv1"


def test_band_summary():
    rows = {"a": {"geo": 11.0, "nme3d": 12.0}, "b": {"geo": 9.0, "nme3d": None}, "c": {"geo": 14.0, "nme3d": 10.0}}
    summary = band_cli.band_summary(rows)
    assert summary["rows"] == rows
    assert summary["min"] == {"geo": 9.0, "nme3d": 10.0} and summary["max"] == {"geo": 14.0, "nme3d": 12.0}
    assert summary["median"] == {"geo": 11.0, "nme3d": 11.0}


@pytest.fixture(scope="module")
def band(tmp_path_factory):
    from neuralnet_tracker_traincode_torch.data.synthetic import write_synthetic_pose_dataset

    work = tmp_path_factory.mktemp("band")
    write_synthetic_pose_dataset(str(work / "aflw2k.h5"), 432, 64, seed=3, device="cpu")  # the CLI keeps it
    mp = pytest.MonkeyPatch()
    mp.setenv("NUM_WORKERS", "1")
    mp.setenv("OMP_NUM_THREADS", "2")
    try:
        code = band_cli.main([str(work), "1", "--seeds", "1", "2", "--device", "cpu", "--batchsize", "16",
                              "--samples-per-epoch", "32"])
    finally:
        mp.undo()
    assert code == 0
    return work


def test_convergence_band_writes_the_shell_scripts_band(band):
    rows = json.loads((band / "band.json").read_text())
    assert list(rows) == [str(band / f"metrics_seed{s}.json") for s in (1, 2)]
    for row in rows.values():
        assert set(row) == {"geo", "nme3d"} and all(np.isfinite(v) for v in row.values())
    assert rows == band_cli.read_band(str(band))
    a, b = rows.values()
    assert a != b  # the seed reaches the run
    for s in (1, 2):
        assert os.path.exists(band / f"run_seed{s}" / NETWORK / "swa.ckpt")


def test_seed_streams_are_what_the_training_cli_uses(band, monkeypatch):
    """The training CLI in this process up to its run: the sampler's seed,
    the model init's generator and the step generator are `seed_streams`'."""
    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.scripts import train_poseestimator as train_cli
    from neuralnet_tracker_traincode_torch.train import loop, run

    seen = {}
    make_loaders, init_state = pipelines.make_pose_estimation_loaders, loop.PoseTrainer.init_state

    def loaders(**kw):
        seen["sampler"] = kw["seed"]
        return make_loaders(**kw)

    def init(self, generator=None, state_dict=None):
        seen["init"] = generator.initial_seed()
        return init_state(self, generator, state_dict)

    class Stop(Exception):
        pass

    def run_training(trainer, state, batches, validation, outdir, generator, **kw):
        seen["steps"] = generator.initial_seed()
        raise Stop

    monkeypatch.setattr(pipelines, "make_pose_estimation_loaders", loaders)
    monkeypatch.setattr(loop.PoseTrainer, "init_state", init)
    monkeypatch.setattr(run, "run_training", run_training)
    monkeypatch.setenv("DATADIR", str(band))
    monkeypatch.setenv("NUM_WORKERS", "1")
    for seed in (5, None):
        seen.clear()
        argv = ["--ds", "aflw2k", "--batchsize", "16", "--samples-per-epoch", "16", "--device", "cpu",
                "--outdir", str(band / "streams")] + ([] if seed is None else ["--seed", str(seed)])
        with pytest.raises(Stop):
            train_cli.main(argv)
        streams = band_cli.seed_streams(seed)
        assert seen["sampler"] == streams.sampler and seen["init"] == streams.init
        if seed is None:
            assert streams == (1234, None, None)
        else:
            assert streams == (5, 6, 5) and seen["steps"] == streams.steps
