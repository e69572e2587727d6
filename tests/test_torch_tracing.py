"""The training step's tracer (`train/tracing.py`, `kernels/stamp.py`) on the
CPU: the stamps of the CPU path in step order per block, an off tracer that
records nothing and changes nothing, the ring's wrap, the clocks' anchors,
the idle gaps' names, the summary's and the profiler split's arithmetic on
synthetic records, and the training run's line. The card's stamps inside a
CUDA graph: `tests/test_torch_kernels_cuda.py`. About 5 s.
"""

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES, stack_batches
from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.kernels import stamp as S
from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
from neuralnet_tracker_traincode_torch.train import tracing as T
from neuralnet_tracker_traincode_torch.train.flagship import flagship_criterion, synthetic_batch
from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
from neuralnet_tracker_traincode_torch.train.run import run_training

K = T.KIND
STEP = ["augment", "forward", "loss", "backward", "optimizer", "step_end"]


def _trainer(steps_per_epoch=2):
    torch.manual_seed(0)
    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                                 backbone_args={"widen_factor": 0.25})
    cfg = TrainerConfig(batchsize=4, epochs=2, samples_per_epoch=4 * steps_per_epoch,
                        aug=TrainAugmentationConfig(inputsize=129, enable_image_aug=True))
    tr = PoseTrainer(model, flagship_criterion(), cfg, LABEL_CATEGORIES, device="cpu")
    return tr, tr.init_state(torch.Generator().manual_seed(0))


def _block(n_steps=2, seed=0):
    b = [synthetic_batch(4, seed + k, src=96) for k in range(n_steps)]
    return {k: torch.stack([torch.from_numpy(x[k]) for x in b]) for k in b[0]}


def _kinds(block):
    return [T.KINDS[k] for k in block.marks[:, 0]]


def test_the_cpu_path_stamps_each_block_in_step_order():
    """On the CPU `train_step_multi` is K eager steps, each a block: load,
    the sections, step_end, block_end, on the host's clock, in order; the
    'draws' span of a block holds its load stamp (one clock)."""
    tr, state = _trainer()
    tr.tracer.enable()
    state, _ = tr.train_step_multi(state, _block(), tr.weight_matrix(0), generator=torch.Generator().manual_seed(1))
    rec = tr.tracer.records()
    blocks = T.split_blocks(rec.stamps)
    assert [b.number for b in blocks] == [1, 2] and rec.stamps_lost == 0 and len(rec.stamps) == 16
    draws = rec.spans[rec.spans[:, 0] == T.HOST_SPANS.index("draws")]
    for b, (_, number, t0, t1) in zip(blocks, draws):
        assert _kinds(b) == ["load"] + STEP + ["block_end"]
        assert b.marks[0, 1] == b.number == number and b.marks[-1, 1] == 1 and (b.marks[1:-1, 1] == 0).all()
        assert (np.diff(b.marks[:, 2]) >= 0).all() and t0 <= b.marks[0, 2] <= t1
    s = T.summarize(rec)
    assert s["blocks"] == 2 and s["steps_per_block"] == 1 and "gradient_mean" not in s["section_ms"]
    per = [T.section_ns(b) for b in blocks]
    assert all(sum(p.values()) == b.end - b.start for p, b in zip(per, blocks))
    assert s["host_part_ms"] == pytest.approx(float((draws[:, 3] - draws[:, 2]).mean()) / 1e6)
    assert s["clock"]["uncertainty_us"] >= 0 and len(rec.anchors) == 2
    assert T.format_summary(s).startswith("trace: 2 blocks of 1 steps")


def test_an_off_tracer_records_nothing_and_changes_nothing():
    """Three trainers from the same weights and draws: tracer on, turned on
    and off again, never on. Their metrics, parameters, buffers and moments
    are bit-equal and so are the kernel counts; the off ones record no
    stamp and no span and add nothing to a graph's key."""
    runs = []
    for mode in ("on", "off again", "never"):
        tr, state = _trainer()
        if mode != "never":
            tr.tracer.enable()
        if mode == "off again":
            tr.tracer.disable()
        ext.reset_launch_counts()
        state, m = tr.train_step_multi(state, _block(), tr.weight_matrix(0),
                                       generator=torch.Generator().manual_seed(1))
        rec = tr.tracer.records()
        runs.append((mode, dict(ext.LAUNCHES), [m[n] for n in m] + tr._state_tensors(state), rec, tr.tracer.key()))
    (_, l_on, on, rec_on, key_on), *offs = runs
    assert len(rec_on.stamps) == 16 and key_on is not None
    for mode, launches, tensors, rec, key in offs:
        assert launches == l_on and all(torch.equal(a, b) for a, b in zip(on, tensors)), mode
        assert len(rec.stamps) == 0 and len(rec.spans) == 0 and key is None, mode
        assert T.summarize(rec)["blocks"] == 0


def test_the_ring_wraps_and_counts_what_it_lost():
    ring, cursor = S.new_ring(4, "cpu")
    for i in range(10):
        S.stamp_plain(ring, cursor, i % 3, i, 1000 + i)
    stamps, lost = S.unroll(ring, cursor)
    assert lost == 6
    np.testing.assert_array_equal(stamps, [[i % 3, i, 1000 + i] for i in range(6, 10)])
    assert S.unroll(*S.new_ring(2, "cpu"))[0].shape == (0, 3)
    with pytest.raises(ValueError):
        S.stamp(ring, cursor, S.KINDS, 0)
    tracer = T.Tracer("cpu", capacity=3).enable()
    for i in range(5):
        tracer.next_block()
        with tracer.span("replay"):
            pass
        tracer.stamp("load")
        tracer.stamp("block_end")
    rec = tracer.records()
    assert rec.stamps_lost == 7 and rec.spans_lost == 2 and list(rec.spans[:, 1]) == [3, 4, 5]
    # the oldest block lost its load stamp: only whole blocks are read
    assert [b.number for b in T.split_blocks(rec.stamps)] == [5]
    tracer.clear()
    assert len(tracer.records().stamps) == 0 and len(tracer.records().spans) == 0


def test_the_anchors_put_the_device_on_the_host_clock():
    """Synthetic clocks: the device reads 1,000 ns ahead at host 0 and 3,000
    ahead at host 1 s, so it gains 2 us a second."""
    a0, a1 = T.Anchor(0, 1000, 40), T.Anchor(10**9, 10**9 + 3000, 70)
    assert a0.offset_ns == 1000 and a1.offset_ns == 3000
    assert T.to_host_ns(500_002_000, [a0, a1]) == 500_000_000  # halfway: 2,000 ahead
    assert T.to_host_ns(1000, [a0]) == 0 and T.to_host_ns(2 * 10**9 + 3000, [a0, a1]) == 2 * 10**9
    assert T.clock_stats([a0, a1]) == {"uncertainty_us": 0.07, "drift_us": 2.0, "over_s": 1.0}
    a = T.Tracer("cpu").enable().anchor()
    assert a.half_ns >= 0 and abs(a.offset_ns) <= a.half_ns


def _synthetic_blocks(numbers, starts):
    """Stamps of one-step blocks numbered `numbers`, from `starts` (ns): each
    of `SEC`'s stamps at its interval's start, then block_end; 10 ms a block."""
    rows = []
    for n, t in zip(numbers, starts):
        for name, ms in SEC:
            rows.append([K[name], n if name == "load" else 0, t])
            t += int(ms * 1e6)
        rows.append([K["block_end"], 1, t])
    return np.asarray(rows, np.int64)


SEC = [("load", 1.0), ("augment", 1.0), ("forward", 2.0), ("loss", 0.5), ("backward", 4.0), ("optimizer", 1.5),
       ("step_end", 0.0)]
MS = 10**6


def test_the_summary_reads_sections_idle_and_host_part():
    """Blocks 1, 2, 3 and 5 of 10 ms, 1 ms apart; block 5 after a pause
    that is not counted, since block 4 is not in the records."""
    stamps = _synthetic_blocks([1, 2, 3, 5], [0, 11 * MS, 22 * MS, 100 * MS])
    D = T.HOST_SPANS.index("draws")
    spans = np.asarray([[D, n, 0, d * MS] for n, d in ((1, 2), (2, 4), (3, 6), (5, 8))]
                       + [[T.HOST_SPANS.index("replay"), 2, 0, MS]], np.int64)
    rec = T.Records(stamps, 0, spans, 0, (T.Anchor(0, 0, 5000), T.Anchor(10**9, 10**9 + 2000, 9000)))
    s = T.summarize(rec)
    assert s["blocks"] == 4 and s["block_ms"] == pytest.approx(10.0)
    assert s["section_ms"] == pytest.approx(dict(SEC))
    assert s["device_idle_pct"] == pytest.approx(100 * 2 / 42)  # 1-2 and 2-3, not 3-5
    assert s["host_part_ms"] == pytest.approx(5.0)
    assert s["clock"] == {"uncertainty_us": 9.0, "drift_us": 2.0, "over_s": 1.0}
    t = T.summarize(rec, skip_blocks=[2])
    assert t["blocks"] == 3 and t["device_idle_pct"] == 0.0 and t["host_part_ms"] == pytest.approx(16 / 3)
    # over a run of consecutive blocks: 1 - the blocks' time / (the last block_end - the first load)
    blocks = T.split_blocks(stamps)[:3]
    whole = blocks[-1].end - blocks[0].start
    assert T.device_idle_pct(blocks) == pytest.approx(100 * (1 - sum(b.end - b.start for b in blocks) / whole))
    assert T.device_idle_pct([]) is None


def test_the_idle_gaps_are_named_by_the_host_span_open_where_they_begin():
    """Four blocks, the device's clock 5 us ahead of the host's; the gaps
    begin at host 10, 21 and 32 ms: inside 'sample' (inside 'draws'),
    inside 'load', and where no span is open."""
    stamps = _synthetic_blocks([1, 2, 3, 4], [0, 11 * MS, 22 * MS, 33 * MS])
    stamps[:, 2] += 5000
    D, SA, L = (T.HOST_SPANS.index(n) for n in ("draws", "sample", "load"))
    spans = np.asarray([[D, 2, 9 * MS, 10.5 * MS], [SA, 2, 9.5 * MS, 10.1 * MS],
                        [D, 3, 20 * MS, 22 * MS], [SA, 3, 20 * MS, 20.5 * MS], [L, 3, 20.5 * MS, 21.2 * MS]],
                       np.int64)
    anchors = (T.Anchor(0, 5000, 100),)
    gaps = T.idle_gaps(T.split_blocks(stamps), spans, anchors)
    assert [(n, t, ns) for n, t, ns in gaps] == [("sample", 10 * MS, MS), ("load", 21 * MS, MS),
                                                 (T.OUTSIDE, 32 * MS, MS)]
    assert T.host_span_at(spans, 20 * MS) == "sample" and T.host_span_at(spans, 21.5 * MS) == "draws"
    s = T.summarize(T.Records(stamps, 0, spans, 0, anchors))
    assert s["idle_gaps_ms"] == pytest.approx({"sample": 1.0, "load": 1.0, T.OUTSIDE: 1.0})
    assert "device idle 6.98% (sample 1.00 ms, " in T.format_summary(s)


def test_a_profile_is_cut_into_sections_at_the_stamp_kernels():
    def stamp(kind):
        return f"void nntc_stamp_kernel<{K[kind]}>(long long*, long long*, long long, long long)"

    ops, t = [("before the first stamp", 0.0, 1.0)], 10.0
    for step in range(2):
        seq = [(stamp("augment"), 1), ("warp_roi_rotate_kernel", 2), ("equalize_kernel", 4),
               (stamp("forward"), 1), ("conv", 10), ("bn", 3), ("conv", 10),
               (stamp("loss"), 1), ("MulFunctor", 2),
               (stamp("backward"), 1), ("conv_dgrad", 20),
               (stamp("optimizer"), 1), ("foreach_add", 5), (stamp("step_end"), 1), ("stack", 1)]
        for name, us in seq:
            ops.append((name, t, t + us))
            t += us + 1
    ops.append((stamp("block_end"), t, t + 1))
    out = T.device_ops_by_section(ops[::-1])  # any order: sorted by start
    sec = out["sections"]
    assert out["steps"] == 2 and out["ops_per_step"] == 8.0
    assert {n: s["ops"] for n, s in sec.items()} == {"augment": 4, "forward": 6, "loss": 2, "backward": 2,
                                                     "optimizer": 2, "step_end": 2}
    assert sec["forward"]["ms"] == pytest.approx(0.046)
    assert sec["forward"]["top"] == [["conv", pytest.approx(0.04), 4], ["bn", pytest.approx(0.006), 2]]


def test_the_training_run_prints_the_tracers_summary_every_epoch(tmp_path, capsys):
    class Validation:
        def run(self, epoch, *recorders):
            return 1.0

    tr, state = _trainer(steps_per_epoch=2)
    tr.tracer.enable()
    singles = [{k: torch.from_numpy(v) for k, v in synthetic_batch(4, s, src=96).items()} for s in range(8)]

    def batches(step):
        return stack_batches(iter(singles[step:]), 2)

    _, records = run_training(tr, state, batches, Validation(), str(tmp_path), steps_per_dispatch=2,
                              generator=torch.Generator().manual_seed(1))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch ")]
    assert len(lines) == 2 and all("; trace: 2 blocks of 1 steps, device ms a block" in ln for ln in lines)
    # each epoch reads its own blocks: the records were cleared after the first
    assert [r["trace"]["blocks"] for r in records] == [2, 2]
    assert records[1]["trace"]["clock"]["over_s"] > 0
