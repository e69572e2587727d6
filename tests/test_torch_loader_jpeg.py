"""The port's loader decoding JPEGs on the card (`FusedBatchLoader(...,
jpeg_decode="device")`: the workers entropy-decode, `device_prefetch` /
`device_prefetch_stacked` finish the decode with K4), here on the CPU
through K4's plain version, against the JAX package's loader (libjpeg) on
the same HDF5 files and sampler seed.

Tolerance: every field of every batch equal (images bit-equal, labels
exact). Also: the shared-memory ring carries a payload at its largest (noise
at quality 100, every coefficient set) in a slot, two data-parallel ranks'
rows decode into the agreed padding, and `$NNTC_NO_NATIVE=1` gives cv2's
host decode.
"""

import itertools
import multiprocessing as mp
import os
import queue

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
from neuralnet_tracker_traincode_torch.data.batch import Batch, Metadata
from neuralnet_tracker_traincode_torch.data.fields import POSE_FIELD_CATEGORIES, FieldCategory, Tag
from neuralnet_tracker_traincode_torch.data.hdf5 import RawJpegBuffer
from neuralnet_tracker_traincode_torch.data.native_loader import JpegCoefficients
from torch_port_helpers import write_random_pose_file as _write

cv2 = pytest.importorskip("cv2")

TAGS = (Tag.POSE_WITH_LANDMARKS, Tag.ONLY_POSE)
JTAGS = (JTag.POSE_WITH_LANDMARKS, JTag.ONLY_POSE)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("loader_jpeg")
    return {
        "a": _write(d / "a.h5", 14, seed=1),
        "b": _write(d / "b.h5", 9, seed=2, with_landmarks=False),
        "big": _write(d / "big.h5", 10, seed=3, big=(2, 7)),
    }


def _datasets(files, names):
    def of(P):
        M = TP if P == "port" else JP
        tags = TAGS if P == "port" else JTAGS
        out = []
        for i, name in enumerate(names):
            ds = M.Hdf5PoseDataset(files[name], dataclass=tags[i], coord_convention_id=i)
            ds.use_raw_images = True
            out.append(ds)
        return out

    return of


def _loaders(datasets_of, stop_after, batchsize=8, pad_size=64, seed=3, **kwargs):
    """(port loader decoding on the card, JAX loader) over one sampler seed."""
    out = []
    for L, S, P, tags, extra in ((TL, TS, "port", TAGS, dict(kwargs, jpeg_decode="device")),
                                 (JL, JS, "jax", JTAGS, kwargs)):
        concat = S.ConcatDataset(datasets_of(P))
        n = len(concat.datasets)
        sampler = S.make_concat_dataset_item_sampler(concat, [0.6, 0.4][:n], stop_after=stop_after, seed=seed)
        out.append(L.FusedBatchLoader(concat, tags.__getitem__, {t: i for i, t in enumerate(tags[:n])}, sampler,
                                      batchsize, pad_size, dataset_weight_by_index=[1.0, 0.5][:n].__getitem__,
                                      **extra))
    return out


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        x = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert x.dtype == want[k].dtype and x.shape == want[k].shape, k
        np.testing.assert_array_equal(x, want[k], err_msg=k)


def test_one_thread_worker_matches_jax(files, capsys):
    port, jax_ = _loaders(_datasets(files, ("a", "b")), stop_after=45)
    assert "JPEG decode on the card" in capsys.readouterr().out
    host = list(port)
    assert all(isinstance(b["image"], JpegCoefficients) for b in host)
    want = list(jax_)
    got = list(TL.device_prefetch(iter(host), device="cpu"))
    assert len(got) == len(want) == 6
    for x, y in zip(got, want):
        _assert_equal(x, y)


def test_a_mixed_batch_is_decoded_on_the_host_counted_and_printed_once(files, capsys):
    """A dataset of decoded frames mixed with one of undecoded JPEGs: a
    batch holding both decodes on the host, as the JAX loader's does; the
    loader counts such batches and prints the first, and every batch equals
    the JAX loader's."""
    datasets_of = _datasets(files, ("a", "b"))

    def mixed(P):
        a, b = datasets_of(P)
        b.use_raw_images = False
        return [a, b]

    port, jax_ = _loaders(mixed, stop_after=45)
    capsys.readouterr()
    got = list(port)
    printed = capsys.readouterr().out
    host_decoded = [b for b in got if not isinstance(b["image"], JpegCoefficients)]
    assert 0 < len(host_decoded) == port.host_decoded_batches
    assert printed.count("not undecoded JPEGs, so it is decoded on the host") == 1
    want = list(jax_)
    assert len(got) == len(want) == 6
    for x, y in zip(TL.device_prefetch(iter(got), device="cpu"), want):
        _assert_equal(x, y)


def test_two_process_workers_over_the_ring_match_jax(files):
    """Process workers with the shared-memory ring on the port's side,
    including batches whose padding grew past the slot (105 x 107 frames:
    they cross through the queue)."""
    port, jax_ = _loaders(_datasets(files, ("big",)), stop_after=30, batchsize=4, num_workers=2)
    assert port.worker_type == "process" and port.shared_memory and port.jpeg_decode == "device"
    got = list(TL.device_prefetch(iter(port), device="cpu"))
    want = list(jax_)
    assert len(got) == len(want) > 0
    assert {tuple(b["image"].shape) for b in got} == {(4, 64, 64, 1), (4, 128, 128, 1)}
    for x, y in zip(got, want):
        _assert_equal(x, y)
    assert not mp.active_children()


def test_device_prefetch_stacked_decodes_each_group(files):
    port, jax_ = _loaders(_datasets(files, ("a", "b")), stop_after=45)
    want = list(jax_)
    groups = list(TL.device_prefetch_stacked(iter(port), device="cpu", steps_per_dispatch=2))
    assert len(groups) == 3
    for g, group in enumerate(groups):
        assert group["image"].shape == (2, 8, 64, 64, 1)
        for k in range(2):
            _assert_equal({n: v[k] for n, v in group.items()}, want[2 * g + k])


class _Frames:
    """Single frames held as JPEG buffers (noise at quality 100: every
    coefficient set, the payload's largest)."""

    def __init__(self, n, size, seed=0):
        rng = np.random.default_rng(seed)
        self.buffers = [np.frombuffer(cv2.imencode(".jpg", rng.integers(0, 256, (size, size - 3), dtype=np.uint8),
                                                   [cv2.IMWRITE_JPEG_QUALITY, 100])[1], np.uint8) for _ in range(n)]
        self.size = size

    def __len__(self):
        return len(self.buffers)

    def __getitem__(self, i):
        fields = {"image": RawJpegBuffer(self.buffers[i], self.size, self.size - 3),
                  "pose": np.asarray([0, 0, 0, 1], np.float32), "index": np.asarray(i, np.int32)}
        cats = {k: POSE_FIELD_CATEGORIES.get(k, FieldCategory.general) for k in fields}
        return Batch(Metadata((self.size - 3, self.size), 0, Tag.ONLY_POSE, None, categories=cats), fields)


def test_the_ring_carries_the_largest_payload_in_a_slot(monkeypatch):
    """A process worker's loop, run in a thread here: a batch of noise at
    quality 100 (every block's 64 coefficients set) with an odd padding goes
    into a shared-memory slot of `shm_slot_bytes`, not through the queue,
    and comes out equal."""
    from multiprocessing import shared_memory

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the worker's loop hides the card from itself
    B, pad, slots = 4, 61, 2
    ds = TS.ConcatDataset([_Frames(B, pad)])
    plan = TL.BatchPlan(list(range(B)), [0] * B, [1.0] * B)
    want = TL._produce_batch(ds, plan, B, pad, 2, jpeg_decode="device")["image"]
    # all but the few blocks whose last coefficient rounds to zero hold 64
    assert 0.95 * TL.payload_bytes_bound(B, pad) < want.nbytes <= TL.payload_bytes_bound(B, pad)
    shm = shared_memory.SharedMemory(create=True, size=TL.shm_slot_bytes(B, pad, "device") * slots)
    try:
        in_q, out_q = queue.Queue(), queue.Queue()
        in_q.put(plan)
        in_q.put(None)
        TL._process_worker_main(ds, in_q, out_q, B, pad, 2, os.getppid(), shm.name, slots, None, "device")
        item = out_q.get_nowait()
        assert isinstance(item, tuple) and item[0] == "shm" and item[4] == pad
        _, slot, seq, layout, _, labels = item
        offset = slot * (shm.size // slots) + TL._SHM_ALIGN
        arrays = [np.ndarray(shape, np.dtype(dt), buffer=shm.buf, offset=offset + off).copy()
                  for off, shape, dt in layout]
        got = JpegCoefficients(*arrays, pad)
        for a, b in zip(got.arrays, want.arrays):
            np.testing.assert_array_equal(a, b)
        assert set(labels) == {"pose", "coord", "roi", "pt3d_68", "shapeparam", "hasface", "coord_convention_id",
                               "tag_id", "dataset_weight", "param_index"}
        del arrays
    finally:
        shm.close()
        shm.unlink()
    host = TL.pack_fused_batch([ds[i] for i in range(B)], [0] * B, pad)
    np.testing.assert_array_equal(got.decode().numpy(), host["image"])


class _FakeRanks:
    """`_agreed_padding`'s all-reduce over two ranks whose other rank pads to `other`."""

    active = True

    def __init__(self, other):
        self.other = other

    def host_all_reduce(self, values, op, dtype):
        assert op == "max"
        return [max(int(values[0]), self.other)]


def test_two_ranks_rows_decode_into_the_agreed_padding(files):
    """Each rank packs its rows of the node's batch; a rank whose frames fit
    64 decodes into the other rank's 128 (its 105 x 107 frames), equal to
    the host decode's rows grown to 128."""
    ds = TS.ConcatDataset([TP.Hdf5PoseDataset(files["big"], dataclass=Tag.ONLY_POSE)])
    ds.datasets[0].use_raw_images = True
    plan = TL.BatchPlan([0, 1, 3, 4, 2, 5, 6, 7], [0] * 8, [1.0] * 8)  # frames 2 and 7 are 105 x 107
    for rows, other in ((slice(0, 4), 128), (slice(4, 8), 64)):
        dev_rows = TL._produce_rows(ds, plan, 8, 64, 2, rows, "device")
        host_rows = TL._produce_rows(ds, plan, 8, 64, 2, rows, "host")
        assert isinstance(dev_rows["image"], JpegCoefficients) and len(dev_rows["image"]) == 4
        (got,) = list(TL._agreed_padding((b for b in [dev_rows]), _FakeRanks(other)))
        (want,) = list(TL._agreed_padding((b for b in [host_rows]), _FakeRanks(other)))
        assert got["image"].shape == want["image"].shape == (4, 128, 128, 1)
        _assert_equal(next(TL.device_prefetch(iter([got]), device="cpu")), want)


def test_nntc_no_native_decodes_with_cv2(files, monkeypatch, capsys):
    monkeypatch.setenv("NNTC_NO_NATIVE", "1")
    port, jax_ = _loaders(_datasets(files, ("a",)), stop_after=16)
    assert port.jpeg_decode == "host"
    assert "cv2 on the host ($NNTC_NO_NATIVE is set)" in capsys.readouterr().out
    for x, y in zip(itertools.islice(port, 2), itertools.islice(jax_, 2)):
        assert isinstance(x["image"], np.ndarray)
        _assert_equal(x, y)


def test_a_refused_file_raises_naming_the_frame():
    """A progressive JPEG in a batch: the ValueError names the frame and its
    index."""

    class Progressive(_Frames):
        def __getitem__(self, i):
            b = super().__getitem__(i)
            if i == 2:
                img = cv2.imdecode(self.buffers[i], 0)
                b["image"] = RawJpegBuffer(np.frombuffer(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1],
                                                         np.uint8), *img.shape)
            return b

    ds = TS.ConcatDataset([Progressive(4, 32)])
    with pytest.raises(ValueError, match=r"frame 2 of the batch \(index 2\).*progressive"):
        TL._produce_batch(ds, TL.BatchPlan([0, 1, 2, 3], [0] * 4, [1.0] * 4), 4, 32, 1, jpeg_decode="device")
