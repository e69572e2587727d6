"""A later cell and metric come as files and entries only: a throwaway
configuration, traffic mix, limits and per-layer metric added to a copy of
the benchmark in a temporary directory, and run there on the CPU."""

import json
import os
import shutil

from tiny import SEED, tiny

from portbench.harness import drive

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    config = json.load(open(os.path.join(ROOT, "portbench", "configs", "posenet-mobilenetv1.json")))
    config["backbone_args"] = {"widen_factor": 0.25, "use_blurpool": False}
    (tmp_path / "portbench" / "configs" / "posenet-mnv1-quarter.json").write_text(json.dumps(config))
    traffic = json.load(open(os.path.join(ROOT, "portbench", "traffic", "b64-k8-resident.json")))
    (tmp_path / "portbench" / "traffic" / "b8-k2-resident.json").write_text(
        json.dumps({**traffic, **tiny()["traffic"], "blocks": 3}))
    (tmp_path / "portbench" / "limits" / "mnv1q-b8-k2-step.json").write_text(
        (tmp_path / "portbench" / "limits" / "mnv1-b64-k8-step.json").read_text())
    (tmp_path / "portbench" / "metrics" / "blocks_seen.py").write_text(
        '"""Blocks in the window."""\n\n\ndef read(ctx):\n    return ctx.window["blocks"]\n')
    bench["configs"].append({"name": "posenet-mnv1-quarter", "source": "https://arxiv.org/abs/1704.04861",
                             "file": "portbench/configs/posenet-mnv1-quarter.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mnv1q-b8-k2-step", "config": "posenet-mnv1-quarter",
                               "traffic": "b8-k2-resident", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "step_img_per_s" == m["name"]:
            m["workloads"].append("mnv1q-b8-k2-step")
    bench["per_layer"].append({"name": "blocks_seen", "unit": "blocks", "better": "higher", "source": "host_clock",
                               "layer": "Trainer, host part", "moves": "step_img_per_s",
                               "workloads": ["mnv1q-b8-k2-step"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    overrides = {"config": {"dtype": "float32"}}
    plain = drive.run_cell("mnv1q-b8-k2-step", SEED, 1.0, False, device="cpu", overrides=overrides,
                           checkout=str(tmp_path), log=lambda *a: None)
    assert plain["correct"] and set(plain["metrics"]) == {"step_img_per_s", "setup_s"}
    traced = drive.run_cell("mnv1q-b8-k2-step", SEED, 1.0, True, device="cpu", overrides=overrides,
                            checkout=str(tmp_path), log=lambda *a: None)
    assert traced["correct"] and traced["metrics"]["blocks_seen"]["value"] >= 1
