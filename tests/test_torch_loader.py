"""The port's host loader (`data/loader.py`: `FusedBatchLoader`, its thread
and process workers, sequences, the padded last batch, pad growth, the
raw-JPEG path and `device_prefetch`) against the JAX package's, on the same
HDF5 files and the same sampler seed.

Tolerance: every field of every batch equal (images bit-equal, labels
exact). The JAX package's video dataset reads its frames through the
repaired subclass `torch_port_helpers.JaxVideoDataset` (the reference
bounds a frame index by its count of sequences).
"""

import itertools
import multiprocessing as mp

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.data import loader as JL
from neuralnet_tracker_traincode_tpu.data import pose_dataset as JP
from neuralnet_tracker_traincode_tpu.data import sampling as JS
from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag
from neuralnet_tracker_traincode_torch.data import loader as TL
from neuralnet_tracker_traincode_torch.data import pose_dataset as TP
from neuralnet_tracker_traincode_torch.data import sampling as TS
from neuralnet_tracker_traincode_torch.data.fields import Tag
from neuralnet_tracker_traincode_torch.data.hdf5 import RawJpegBuffer
from torch_port_helpers import JaxVideoDataset as _JaxVideoDataset
from torch_port_helpers import write_random_pose_file as _write


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("loader")
    return {
        "a": _write(d / "a.h5", 14, seed=1),
        "b": _write(d / "b.h5", 9, seed=2, with_landmarks=False),
        "big": _write(d / "big.h5", 10, seed=3, big=(2, 7)),
        "video": _write(d / "video.h5", 16, seed=4, sequence_starts=[0, 3, 4, 9, 16]),
    }


TAGS = (Tag.POSE_WITH_LANDMARKS, Tag.ONLY_POSE)
JTAGS = (JTag.POSE_WITH_LANDMARKS, JTag.ONLY_POSE)


def _loaders(datasets_of, stop_after, batchsize=8, pad_size=64, weights=(0.6, 0.4), loss_weights=(1.0, 0.5),
             seed=3, **kwargs):
    """(port loader, JAX loader) over `datasets_of(package)`, one sampler seed."""
    out = []
    for L, S, P, tags in ((TL, TS, "port", TAGS), (JL, JS, "jax", JTAGS)):
        concat = S.ConcatDataset(datasets_of(P))
        n = len(concat.datasets)
        sampler = S.make_concat_dataset_item_sampler(concat, list(weights[:n]), stop_after=stop_after, seed=seed)
        out.append(L.FusedBatchLoader(concat, tags.__getitem__, {t: i for i, t in enumerate(tags[:n])}, sampler,
                                      batchsize, pad_size, dataset_weight_by_index=list(loss_weights[:n]).__getitem__,
                                      **kwargs))
    return out


def _assert_equal_streams(got, want, n=None):
    got, want = list(itertools.islice(got, n)), list(itertools.islice(want, n))
    assert len(got) == len(want) > 0
    for b, (x, y) in enumerate(zip(got, want)):
        assert set(x) == set(y)
        for k in y:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (b, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"batch {b}, {k}")
    return got


def _two_files(files, raw=True):
    def datasets_of(P):
        M = TP if P == "port" else JP
        tags = TAGS if P == "port" else JTAGS
        out = [M.Hdf5PoseDataset(files["a"], dataclass=tags[0]),
               M.Hdf5PoseDataset(files["b"], dataclass=tags[1], coord_convention_id=1)]
        for ds in out:
            ds.use_raw_images = raw
        return out

    return datasets_of


def test_one_thread_worker_matches_jax(files):
    port, jax_ = _loaders(_two_files(files), stop_after=45)
    assert port.worker_type == "thread"
    got = _assert_equal_streams(iter(port), iter(jax_))
    assert len(got) == 6 and {0, 1} <= set(np.concatenate([b["tag_id"] for b in got]).tolist())
    assert set(np.concatenate([b["dataset_weight"] for b in got[:-1]]).tolist()) == {1.0, 0.5}
    # the stream ends in a short plan of 5 frames, filled with its first frame at weight 0
    last = got[-1]
    np.testing.assert_array_equal(last["dataset_weight"][5:], 0.0)
    assert (last["dataset_weight"][:5] > 0).all()
    for k in set(last) - {"dataset_weight"}:
        for i in range(5, 8):
            np.testing.assert_array_equal(last[k][i], last[k][0], err_msg=k)


def test_two_process_workers_with_shared_memory_match_jax(files):
    """Process workers on both sides, including a batch whose padding grew
    past the shared-memory slot (it crosses through the queue)."""

    def datasets_of(P):
        M = TP if P == "port" else JP
        out = [M.Hdf5PoseDataset(files["big"], dataclass=(TAGS if P == "port" else JTAGS)[0])]
        out[0].use_raw_images = True
        return out

    port, jax_ = _loaders(datasets_of, stop_after=30, batchsize=4, num_workers=2)
    assert port.worker_type == "process" and port.shared_memory
    got = _assert_equal_streams(iter(port), iter(jax_))
    shapes = {b["image"].shape for b in got}
    assert (4, 64, 64, 1) in shapes and (4, 128, 128, 1) in shapes  # 105 x 107 frames grow the padding to 128
    for b in got:  # the padding is zero
        assert not b["image"][:, 48:, 52:].any() or b["image"].shape[1] == 128


def test_sequences_with_carry_match_jax(files):
    """A video set (mini-sequences of 2 to 4 frames, the last one split)
    beside single frames: each plan holds 8 frames at most, a sequence that
    does not fit opens the next plan, and its frames share a param_index."""

    def datasets_of(P):
        if P == "port":
            video = TP.Hdf5PoseVideoDataset(files["video"], 2, 4, dataclass=Tag.POSE_WITH_LANDMARKS)
            single = TP.Hdf5PoseDataset(files["b"], dataclass=Tag.ONLY_POSE)
        else:
            video = _JaxVideoDataset(files["video"], 2, 4, dataclass=JTag.POSE_WITH_LANDMARKS)
            single = JP.Hdf5PoseDataset(files["b"], dataclass=JTag.ONLY_POSE)
        return [video, single]

    port, jax_ = _loaders(datasets_of, stop_after=40, weights=(0.7, 0.3))
    assert [tuple(p) for p in port.plan_batches()] == [tuple(p) for p in jax_.plan_batches()]
    got = _assert_equal_streams(iter(port), iter(jax_))
    carried = 0
    for b in got:
        assert b["image"].shape[0] == 8
        real = b["dataset_weight"] > 0  # the last batch's filler repeats frame 0 at weight 0
        pidx = b["param_index"][real]
        shared = [pi for pi in np.unique(pidx) if (pidx == pi).sum() > 1]
        carried += len(shared)
        for pi in shared:  # a sequence's frames: one param_index, consecutive slots
            idx = np.nonzero(pidx == pi)[0]
            assert idx[0] == pi and (np.diff(idx) == 1).all()
    assert carried > 0
    plans = list(port.plan_batches())
    frames = [sum(TL.frame_count(port.ds, i) for i in p.indices) for p in plans]
    assert max(frames) <= 8 and min(frames[:-1]) < 8  # some plan was cut short by a carried sequence


def test_plan_batches_resume_at_a_step(files):
    port, _ = _loaders(_two_files(files), stop_after=45)
    full = list(port)
    again, _ = _loaders(_two_files(files), stop_after=45)
    _assert_equal_streams(again.iterate(start=2), iter(full[2:]))


class _Boom:
    def __call__(self, sample):
        raise RuntimeError("boom")


@pytest.mark.parametrize("num_workers,worker_type", [(1, "thread"), (2, "process")])
def test_worker_exception_reaches_the_consumer(files, num_workers, worker_type):
    port, _ = _loaders(_two_files(files), stop_after=45, num_workers=num_workers, worker_type=worker_type)
    port.ds.datasets[0].transform = _Boom()  # after construction: the worker's copy raises on load
    with pytest.raises(RuntimeError, match="boom"):
        list(iter(port))
    assert not mp.active_children()


class _ExplodingSampler:
    def __iter__(self):
        yield from range(16)
        raise RuntimeError("sampler exploded")


def test_sampler_error_reaches_the_consumer(files):
    port, _ = _loaders(_two_files(files), stop_after=45)
    port.sampler = _ExplodingSampler()
    got = []
    with pytest.raises(RuntimeError, match="sampler exploded"):
        for b in port:
            got.append(b)
    assert len(got) == 2


def test_no_worker_outlives_its_iterator(files):
    port, _ = _loaders(_two_files(files), stop_after=10**9, num_workers=2, worker_type="process")
    it = iter(port)
    next(it)
    assert len(mp.active_children()) == 2
    it.close()
    assert not mp.active_children()


def test_device_prefetch_on_the_cpu_gives_the_batches_as_tensors(files):
    port, jax_ = _loaders(_two_files(files), stop_after=45)
    want = list(jax_)
    got = list(TL.device_prefetch(iter(port), device="cpu"))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert set(x) == set(y)
        for k in y:
            assert isinstance(x[k], torch.Tensor) and x[k].device.type == "cpu"
            np.testing.assert_array_equal(x[k].numpy(), y[k], err_msg=k)


@pytest.mark.parametrize("decode_threads", [1, 3])
def test_raw_jpeg_path_equals_the_decoded_path(files, decode_threads):
    dec = TP.Hdf5PoseDataset(files["big"], dataclass=Tag.ONLY_POSE)
    raw = TP.Hdf5PoseDataset(files["big"], dataclass=Tag.ONLY_POSE)
    raw.use_raw_images = True
    assert isinstance(raw[0]["image"], RawJpegBuffer) and raw[0].meta.image_wh == dec[0].meta.image_wh
    idx = [0, 2, 5, 7, 9]
    a = TL.pack_fused_batch([dec[i] for i in idx], [0] * 5, 64)
    b = TL.pack_fused_batch([raw[i] for i in idx], [0] * 5, 64, decode_threads=decode_threads)
    assert a["image"].shape == (5, 128, 128, 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jraw = JP.Hdf5PoseDataset(files["big"], dataclass=JTag.ONLY_POSE)
    jraw.use_raw_images = True
    c = JL.pack_fused_batch([jraw[i] for i in idx], [0] * 5, 64, allow_pad_growth=True)
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
