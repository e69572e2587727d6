"""The plain reference: it imports nothing of the port, of JAX or of the
JAX package, and on the CPU in float32 it follows the port's first block
(crops, network, losses, Adam, BatchNorm statistics) to rounding."""

import json
import os
import subprocess
import sys

import pytest
import torch
from tiny import CELLS, SEED, tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, pkgutil, importlib, portbench.reference as R\n"
            "for m in pkgutil.walk_packages(R.__path__, 'portbench.reference.'): importlib.import_module(m.name)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    names = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not names & {"neuralnet_tracker_traincode_torch", "neuralnet_tracker_traincode_tpu", "jax", "jaxlib",
                        "flax"}


def test_reference_state_dict_is_the_ports():
    from portbench.harness import program
    from portbench.reference import model as M

    for name in ("posenet-mobilenetv1", "posenet-resnet18"):
        config = json.load(open(os.path.join(ROOT, "portbench", "configs", name + ".json")))
        ref = M.PoseNetwork(config).state_dict()
        tr, _ = program.trainer(config, "cpu")
        port = tr.model.state_dict()
        assert list(ref) == list(port)
        assert all(ref[k].shape == port[k].shape for k in ref)
        for k in ("landmarks.deformablekeypoints.keypts", "landmarks.deformablekeypoints.keyeigvecs"):
            assert torch.equal(ref[k], port[k])


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port_in_float32(cell):
    from portbench.harness import drive

    run = drive.Setup(cell, SEED, "cpu", tiny())
    numbers = drive.reference_numbers(run.config, run.sd0, run.release(), run.first_metrics, run.after_first, SEED,
                                      run.dev)
    assert numbers["loss"] < 1e-4 and numbers["terms"] < 1e-3, numbers
    assert numbers["moment"] < 0.02 and numbers["change"] < 0.02 and numbers["bn"] < 1e-5, numbers
