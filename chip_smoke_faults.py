"""Phase 15 of `chip_smoke.py` (data-parallel training) with faults planted
in memory, one after another, its checks recorded instead of failing: the
readings of the sound run and of each fault, between which `chip_smoke.py`'s
`DP_*` limits are fixed. Needs the card; from the repo's root:

    python3 chip_smoke_faults.py none bn_xmu_dropped bn_dx_sign bn_count_doubled bn_unsynced grads_summed

The faults: `bn_xmu_dropped`, `bn_dx_sign` and `bn_count_doubled` patch
`torch.batch_norm_backward_elemt` (the synchronized BatchNorm's input
gradient on the card: the `sum(dy * x_hat)` term dropped, the sign flipped,
the count doubled); `bn_unsynced` normalises each rank by its own rows;
`grads_summed` sums the gradients over the ranks instead of averaging them.
The spawned ranks of part (b) plant the same fault. Nothing on disk changes.
Exits 1 unless the sound run passes every check and every other fault but
`grads_summed` fails one: Adam and the global-norm clip divide the
gradient's scale out, so summing instead of averaging changes no result
while the clip binds, as it does at the flagship's first steps.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as C  # noqa: E402

RECORDED = []
INVISIBLE = {"grads_summed"}


def record_check(cond, msg):
    """`chip_smoke.check`, recording a failure instead of exiting."""
    if not cond:
        RECORDED.append(msg)
        print("CHECK WOULD FAIL: " + msg[:700], flush=True)


def plant(fault):
    """Plant `fault`; returns a function that removes it."""
    import torch

    from neuralnet_tracker_traincode_torch.models.backbones import common
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer

    C.check = record_check
    if fault == "none":
        return lambda: None
    if fault.startswith("bn_"):
        if fault == "bn_unsynced":  # each rank normalises by its own rows
            forward = common.BatchNorm2d.forward

            def unsynced(self, x):
                sync, self.sync = self.sync, None
                try:
                    return forward(self, x)
                finally:
                    self.sync = sync

            common.BatchNorm2d.forward = unsynced
            return lambda: setattr(common.BatchNorm2d, "forward", forward)
        orig = torch.batch_norm_backward_elemt

        def fake(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count):
            if fault == "bn_xmu_dropped":
                return orig(dy, x, mean, invstd, weight, sum_dy, torch.zeros_like(sum_dy_xmu), count)
            if fault == "bn_dx_sign":
                return -orig(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count)
            if fault == "bn_count_doubled":
                return orig(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count * 2)
            raise ValueError(fault)

        torch.batch_norm_backward_elemt = fake
        return lambda: setattr(torch, "batch_norm_backward_elemt", orig)
    if fault == "grads_summed":  # the gradients summed over the ranks, not averaged
        mean = PoseTrainer._mean_over_ranks

        def summed(self, grads):
            return {k: v * self.parallel.ranks for k, v in mean(self, grads).items()}

        PoseTrainer._mean_over_ranks = summed
        return lambda: setattr(PoseTrainer, "_mean_over_ranks", mean)
    raise ValueError(fault)


def rank_main(rank, port, workdir):
    """A rank of phase 15 (b) with the fault named in `DP_FAULT` planted."""
    plant(os.environ["DP_FAULT"])
    C.dp_rank_main(rank, port, workdir)


def main() -> int:
    """Phase 14a's reference (its batches, eager and graph metrics), then
    phase 15 once per fault named on the command line."""
    import numpy as np
    import torch

    from neuralnet_tracker_traincode_torch.kernels import ext

    smi = C.card_line()
    print(smi)
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())
    t0 = time.time()
    ext.extension()
    print("built", time.time() - t0)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, state, W = C.flagship_trainer(torch, dev)
    singles, groups = C.flagship_batches(torch, np, dev, C.B, 2 * C.MS_K, C.MS_K)
    saved = C.state_snapshot(trainer, state)
    trainer.train_step(state, singles[0], W, generator=torch.Generator().manual_seed(1))
    C.state_restore(torch, trainer, state, saved)
    floor, diff, _, graph_ms, launches, eager_metrics, graph_metrics = C.against_eager(
        torch, trainer, state, singles, groups, W, "flagship, K=8")
    print(f"phase 14a's reference: eager floor {floor}, graph {diff}, {graph_ms:.3f} ms a step, launches {launches}")
    flagship = dict(eager_metrics=eager_metrics, graph_metrics=graph_metrics, graph_ms=graph_ms)
    del trainer, state
    C.dp_rank_main = rank_main
    failed = {}
    for fault in sys.argv[1:]:
        print(f"===== fault {fault}", flush=True)
        os.environ["DP_FAULT"] = fault
        RECORDED.clear()
        undo = plant(fault)
        t0 = time.time()
        try:
            C.data_parallel_phase(torch, np, dev, smi, flagship, {C.B: [("graph", graph_ms)]})
        except Exception as e:  # a fault may break the run itself: that counts as caught
            RECORDED.append(f"raised {type(e).__name__}: {e}")
            print(f"fault {fault}: the phase raised {type(e).__name__}: {e}", flush=True)
        finally:
            undo()
        print(f"===== fault {fault}: {len(RECORDED)} checks would fail; {time.time() - t0:.1f} s", flush=True)
        failed[fault] = len(RECORDED)
    print(smi)
    print(json.dumps({"checks_failed": failed}))
    return int(any((n > 0) if f in INVISIBLE | {"none"} else (n == 0) for f, n in failed.items()))


if __name__ == "__main__":
    sys.exit(main())
