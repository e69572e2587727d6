"""The host loader (counterpart of the JAX package's `data/loader.py`):
batch plans, fused-batch packing, the worker pool and the upload to the card.

`pack_fused_batch` packs labelled frames into the fixed-shape fused-batch
dict that `PoseTrainer.train_step` and `FusedValidation` take: images
zero-padded (not rescaled) to (B, pad, pad, C) uint8, every field of
`LABEL_SCHEMA` present (zero where a frame lacks it, masked by the per-tag
loss weights), `hasface` label-smoothed to 0.9 / 0.1, and `tag_id`,
`dataset_weight`, `param_index` and `coord_convention_id` per frame. A
sample is a single-frame `Batch` of either package (`data/batch.py:frame`
makes the port's), or a sequence (`meta.seq`) whose frames share one
`param_index`. Undecoded JPEGs (`data/hdf5.py:RawJpegBuffer`) are decoded
on `decode_threads` threads: by cv2 (`jpeg_decode="host"`), or, with
`jpeg_decode="device"` and every image of the batch undecoded, only
entropy-decoded (`data/native_loader.py`), so that "image" holds a
`JpegCoefficients` payload that the upload decodes on the card with K4
(`kernels/jpeg.py`) into the same padded batch, bit for bit.

`plan_batches` cuts a sampler's index stream (`data/sampling.py`) into
batch plans of `batchsize` frames, carrying a sequence that does not fit
into the next plan. `FusedBatchLoader` dispatches the plans round-robin to
thread or spawned process workers and reads the batches back in the same
order, so the stream is the same for any worker count and type; process
workers hand the image plane (or the payload) over through a shared-memory
ring, from which a reader thread copies each batch out, into pinned memory
where a card is present, ahead of the consumer. Workers never touch CUDA. `device_prefetch` uploads batches to the card ahead of
the consumer from pinned memory on a side stream; `device_prefetch_stacked`
does so for groups of K batches stacked on a leading axis, the input of
`PoseTrainer.train_step_multi` (`stack_batches` stacks batches that are on
the card already). `iterate_fused_batches` makes training batches of a
packed set already held on the card.

Data-parallel (`parallel/distributed.py`): with `rows`, a loader plans the
node's batches from its one sampler stream as before and packs only this
rank's rows of each (`_produce_rows`); `FusedBatchLoader` with a process
group then pads every batch to the largest padding of any rank's same batch,
so that the ranks' shapes, and so their CUDA graphs, agree.
"""

import atexit
import bisect
import collections
import functools
import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.data.fields import POSE_FIELD_CATEGORIES
from neuralnet_tracker_traincode_torch.data.hdf5 import RawJpegBuffer
from neuralnet_tracker_traincode_torch.data.native_loader import (
    JpegCoefficients,
    decode_mode,
    entropy_decode,
    get_lib,
    payload_bytes_bound,
)
from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.parallel.distributed import DataParallel, local_rows
from neuralnet_tracker_traincode_torch.utils import ceil_to_multiple

LABEL_SCHEMA = {
    "pose": (4,),
    "coord": (3,),
    "roi": (4,),
    "pt3d_68": (68, 3),
    "shapeparam": (50,),
    "hasface": (),
}

LABEL_CATEGORIES = {k: POSE_FIELD_CATEGORIES[k] for k in LABEL_SCHEMA}

# Each slot of the shared-memory image ring starts with the producer's int64
# sequence number, which the consumer checks on both sides of its copy-out;
# the arrays follow it from byte 64 of the slot on, each on a 64-byte boundary.
_SHM_ALIGN = 64


def _image_dims(im):
    if isinstance(im, RawJpegBuffer):
        return im.height, im.width
    if not isinstance(im, (np.ndarray, torch.Tensor)):
        raise TypeError(f"cannot pack a {type(im).__name__} image")
    return tuple(im.shape[:2])


def _materialize(im) -> np.ndarray:
    if isinstance(im, RawJpegBuffer):
        return im.decode()
    if isinstance(im, torch.Tensor):
        return im.detach().cpu().numpy()
    return im


@functools.lru_cache(maxsize=None)
def _decode_pool(threads: int) -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=threads, thread_name_prefix="nntc-decode")


def pack_fused_batch(
    samples: Sequence[Mapping[str, Any]],
    tag_ids: Sequence[int],
    pad_size: int,
    dataset_weights: Optional[Sequence[float]] = None,
    decode_threads: Optional[int] = None,
    jpeg_decode: str = "host",
) -> Dict[str, Any]:
    """Pack samples (single frames or sequences) into one fused batch dict of
    numpy arrays. An image larger than `pad_size` grows this batch's padding
    to the next multiple of 64. Undecoded JPEGs are decoded on
    `decode_threads` threads (default: one); with `jpeg_decode="device"` a
    batch of undecoded JPEGs only, entropy-decoded, is a `JpegCoefficients`
    payload under "image" (ValueError naming the frame for a file the
    entropy decoder refuses)."""
    frames, frame_tags, frame_weights, param_index = [], [], [], []
    for si, s in enumerate(samples):
        start = len(frames)
        seq = getattr(getattr(s, "meta", None), "seq", None)
        for f in ([f for q in s.undo_collate() for f in q.iter_frames()] if seq else [s]):
            frames.append(f)
            frame_tags.append(tag_ids[si])
            frame_weights.append(1.0 if dataset_weights is None else dataset_weights[si])
            param_index.append(start)
    raw = [f["image"] for f in frames]
    B = len(frames)
    largest = max(max(_image_dims(im)) for im in raw)
    if largest > pad_size:
        pad_size = ceil_to_multiple(largest)

    threads = max(1, int(decode_threads or 1))
    images = None
    if decode_mode(jpeg_decode) == "device" and all(isinstance(im, RawJpegBuffer) for im in raw):
        names = [f"frame {i} of the batch" + (f" (index {int(f['index'])})" if "index" in f else "")
                 for i, f in enumerate(frames)]
        images = entropy_decode([im.buffer for im in raw], pad_size, threads, names)
    if images is None:
        first = _materialize(raw[0])
        images = np.zeros((B, pad_size, pad_size, first.shape[-1]), np.uint8)

        def put(i, im):
            img = first if i == 0 else _materialize(im)
            images[i, : img.shape[0], : img.shape[1], :] = img

        if threads > 1 and sum(isinstance(im, RawJpegBuffer) for im in raw) > 1:
            list(_decode_pool(threads).map(put, range(B), raw))  # cv2 releases the GIL while it decodes
        else:
            for i, im in enumerate(raw):
                put(i, im)

    out: Dict[str, Any] = {"image": images}
    for k, shape in LABEL_SCHEMA.items():
        out[k] = np.zeros((B,) + shape, np.float32)
    out["coord_convention_id"] = np.zeros((B,), np.int32)
    for i, f in enumerate(frames):
        for k in LABEL_SCHEMA:
            if k in f:
                v = np.asarray(f[k])
                if v.dtype == np.bool_ or k == "hasface":
                    v = np.where(v.astype(np.float32) > 0.5, 0.9, 0.1)  # label smoothing of binary labels
                out[k][i] = v.astype(np.float32)
        if "coord_convention_id" in f:
            out["coord_convention_id"][i] = int(f["coord_convention_id"])
    out["tag_id"] = np.asarray(frame_tags, np.int32)
    out["dataset_weight"] = np.asarray(frame_weights, np.float32)
    out["param_index"] = np.asarray(param_index, np.int32)
    return out


class BatchPlan(NamedTuple):
    """The composition of one fused batch: global indices into the concat
    dataset and the tag id and loss weight of each sample."""

    indices: List[int]
    tag_ids: List[int]
    weights: List[float]


def frame_count(ds, index: int) -> int:
    """Frames that sample `index` of `ds` contributes, from the metadata
    alone (through ConcatDataset, Subset and TransformedDataset wrappers): a
    sequence's length, else 1."""
    while True:
        if hasattr(ds, "cumulative_sizes"):  # ConcatDataset
            dsi = bisect.bisect_right(ds.cumulative_sizes, index)
            start = 0 if dsi == 0 else ds.cumulative_sizes[dsi - 1]
            ds, index = ds.datasets[dsi], index - start
        elif hasattr(ds, "indices"):  # Subset
            ds, index = ds.dataset, int(ds.indices[index])
        elif hasattr(ds, "sequence_frame_count"):
            return int(ds.sequence_frame_count(index))
        elif hasattr(ds, "dataset"):  # TransformedDataset
            ds = ds.dataset
        else:
            return 1


def plan_batches(
    concat_dataset,
    tags_by_dataset_index: Callable[[int], Any],
    tag_to_id: Dict[Any, int],
    sampler: Iterable[int],
    batchsize: int,
    dataset_weight_by_index: Optional[Callable[[int], float]] = None,
) -> Iterator[BatchPlan]:
    """Cut the sampler's stream into plans of `batchsize` frames, with the tag
    id and weight of each sample's dataset (the JAX loader's
    `FusedBatchLoader.plan_batches`). A sequence that would overflow a plan
    that already has samples opens the next one; a finite stream ends with
    its last, shorter plan."""
    cumsizes = np.asarray(concat_dataset.cumulative_sizes)
    n_ds = len(concat_dataset.datasets)
    tag_id_by_ds = [tag_to_id[tags_by_dataset_index(i)] for i in range(n_ds)]
    weight_by_ds = [1.0 if dataset_weight_by_index is None else float(dataset_weight_by_index(i)) for i in range(n_ds)]
    carry = None
    it = iter(sampler)
    while True:
        plan = BatchPlan([], [], [])
        frames = 0
        while frames < batchsize:
            if carry is not None:
                (gi, n), carry = carry, None
            else:
                try:
                    gi = int(next(it))
                except StopIteration:
                    if plan.indices:
                        yield plan
                    return
                n = frame_count(concat_dataset, gi)
            if frames + n > batchsize and plan.indices:
                carry = (gi, n)
                break
            dsi = int(np.searchsorted(cumsizes, gi, side="right"))
            plan.indices.append(gi)
            plan.tag_ids.append(tag_id_by_ds[dsi])
            plan.weights.append(weight_by_ds[dsi])
            frames += n
        yield plan


def _produce_batch(ds, plan: BatchPlan, batchsize: int, pad_size: int, decode_threads: int,
                   rows: Optional[slice] = None, jpeg_decode: str = "host") -> Dict[str, Any]:
    """The fused batch of `plan`; a short one (the stream's last) filled up
    with repeats of its first frame at weight 0, so that shapes stay fixed.
    With `rows`, only those rows of it (`_produce_rows`)."""
    if rows is not None:
        return _produce_rows(ds, plan, batchsize, pad_size, decode_threads, rows, jpeg_decode)
    batch = pack_fused_batch([ds[gi] for gi in plan.indices], plan.tag_ids, pad_size, plan.weights, decode_threads,
                             jpeg_decode)
    B = batch["tag_id"].shape[0]
    if B < batchsize:
        take = np.concatenate([np.arange(B), np.zeros(batchsize - B, np.int64)])
        batch = {k: v[take] for k, v in batch.items()}
        batch["dataset_weight"][B:] = 0.0
    return batch


def _produce_rows(ds, plan: BatchPlan, batchsize: int, pad_size: int, decode_threads: int,
                  rows: slice, jpeg_decode: str = "host") -> Dict[str, Any]:
    """Rows `rows` of `_produce_batch(ds, plan, batchsize, ...)`, equal to
    them field for field but for the padding, which follows only the images
    packed here. Only the samples with a frame in `rows` are read and
    decoded (a sequence across the rows' edge whole), and `param_index` is
    in the whole batch's row numbers: a sequence may begin in rows that
    another rank packs."""
    counts = [frame_count(ds, gi) for gi in plan.indices]
    starts = np.cumsum([0] + counts[:-1])
    frames = int(sum(counts))
    wanted = np.arange(rows.start, rows.stop)
    source = np.where(wanted < frames, wanted, 0)  # a short batch's fill repeats its first frame
    sample = np.searchsorted(starts, source, side="right") - 1
    chosen = sorted(set(sample.tolist()))
    packed = pack_fused_batch([ds[plan.indices[s]] for s in chosen], [plan.tag_ids[s] for s in chosen], pad_size,
                              [plan.weights[s] for s in chosen], decode_threads, jpeg_decode)
    first_row = dict(zip(chosen, np.cumsum([0] + [counts[s] for s in chosen[:-1]]).tolist()))
    take = np.asarray([first_row[s] + r - starts[s] for r, s in zip(source.tolist(), sample.tolist())])
    batch = {k: v[take] for k, v in packed.items()}
    batch["param_index"] = starts[sample].astype(np.int32)
    batch["dataset_weight"][wanted >= frames] = 0.0
    return batch


def _agreed_padding(batches: Iterator[Dict[str, Any]], parallel: DataParallel) -> Iterator[Dict[str, Any]]:
    """The batches of `batches`, each image plane zero-padded to the largest
    padding of any rank's same batch (one host all-reduce a batch); a JPEG
    payload is decoded into slots of that padding."""
    try:
        for batch in batches:
            img = batch["image"]
            (pad,) = parallel.host_all_reduce([img.shape[1]], "max", torch.int64)
            if isinstance(img, JpegCoefficients):
                batch = dict(batch, image=img.with_pad(pad))
            elif pad > img.shape[1]:
                grown = np.zeros((img.shape[0], pad, pad) + img.shape[3:], img.dtype)
                grown[:, : img.shape[1], : img.shape[2]] = img
                batch = dict(batch, image=grown)
            yield batch
    finally:
        batches.close()


def _image_arrays(image) -> List[np.ndarray]:
    """The arrays that carry a batch's "image": the plane, or a payload's."""
    return [np.asarray(a) for a in image.arrays] if isinstance(image, JpegCoefficients) else [image]


def _shm_layout(arrays: Sequence[np.ndarray]) -> List[tuple]:
    """(offset after the stamp, shape, dtype) of each array in a slot."""
    layout, offset = [], 0
    for a in arrays:
        layout.append((offset, a.shape, a.dtype.str))
        offset += -(-a.nbytes // _SHM_ALIGN) * _SHM_ALIGN
    return layout


def _shm_bytes(layout: Sequence[tuple]) -> int:
    if not layout:
        return 0
    offset, shape, dtype = layout[-1]
    return offset + int(np.prod(shape)) * np.dtype(dtype).itemsize


def shm_slot_bytes(batchsize: int, pad_size: int, jpeg_decode: str = "host") -> int:
    """A ring slot: the stamp's 64 bytes and the planned batch's image plane
    at one uint8 channel or, decoding on the card, its JPEG payload at its
    largest (`payload_bytes_bound`, each of its four arrays on a 64-byte
    boundary). A batch that does not fit (its padding grew) goes through
    the queue whole."""
    plane = batchsize * pad_size * pad_size
    if jpeg_decode == "device":
        plane = max(plane, payload_bytes_bound(batchsize, pad_size) + 4 * _SHM_ALIGN)
    return _SHM_ALIGN + plane


def _host_array(shape, dtype) -> np.ndarray:
    """An empty host array, page-locked (a view of a pinned tensor) where a
    card is present, so that `device_prefetch` uploads it without copying
    it again."""
    if torch.cuda.is_available():
        torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return torch.empty(tuple(shape), dtype=torch_dtype, pin_memory=True).numpy()
    return np.empty(shape, dtype)


def _process_worker_main(ds, in_q, out_q, batchsize, pad_size, decode_threads, parent_pid, shm_name=None,
                         shm_slots=0, rows=None, jpeg_decode="host"):
    """A spawned worker: the batches of the plans it is sent, in order.

    With `shm_name`, the image plane of each batch (or its JPEG payload's
    arrays) goes into the next slot of that shared-memory ring and the
    message carries (slot, seq, the arrays' layout, the payload's padding or
    None, the labels); a batch whose padding outgrew its slot goes through
    the queue whole. The ring has qsize + 3 slots: at most qsize batches wait
    in the queue and one in a blocked put beyond the one the consumer copies
    out, so a slot is never rewritten before it is read. The slot's stamp is
    written before the image, so a lap would show on either side of the
    consumer's copy. Exceptions go to the consumer. The worker ends when its
    parent is gone (the orphan watchdog) or sends None.
    """
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the worker never touches the card
    shm = None
    try:
        slot_bytes = 0
        if shm_name is not None:
            from multiprocessing import shared_memory

            shm = shared_memory.SharedMemory(name=shm_name)
            slot_bytes = shm.size // shm_slots - _SHM_ALIGN
        seq = 0

        def orphaned() -> bool:
            return os.getppid() != parent_pid

        def put_or_exit(item) -> bool:
            while True:
                try:
                    out_q.put(item, timeout=5)
                    return True
                except queue.Full:
                    if orphaned():
                        out_q.cancel_join_thread()
                        return False

        while True:
            try:
                plan = in_q.get(timeout=5)
            except queue.Empty:
                if orphaned():
                    return
                continue
            if plan is None:
                return
            try:
                batch = _produce_batch(ds, plan, batchsize, pad_size, decode_threads, rows, jpeg_decode)
            except Exception as e:  # noqa: BLE001 - forwarded to the consumer
                put_or_exit(e)
                return
            img = batch["image"]
            arrays = _image_arrays(img)
            layout = _shm_layout(arrays)
            if shm is not None and _shm_bytes(layout) <= slot_bytes:
                slot = seq % shm_slots
                offset = slot * (slot_bytes + _SHM_ALIGN)
                np.ndarray((), np.int64, buffer=shm.buf, offset=offset)[...] = seq
                for a, (off, shape, dtype) in zip(arrays, layout):
                    np.ndarray(shape, dtype, buffer=shm.buf, offset=offset + _SHM_ALIGN + off)[...] = a
                pad = img.pad if isinstance(img, JpegCoefficients) else None
                item = ("shm", slot, seq, layout, pad, {k: v for k, v in batch.items() if k != "image"})
            else:
                item = batch
            seq += 1
            if not put_or_exit(item):
                return
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    finally:
        if shm is not None:
            shm.close()


class FusedBatchLoader:
    """Fixed-size fused training batches with background workers.

    `concat_dataset` concatenates the datasets; `tags_by_dataset_index(i)`
    gives dataset i's tag and `tag_to_id` its id; the sampler yields global
    indices. Each batch holds `batchsize` frames (a sequence counts its
    length). Plans are cut by one consumer of the sampler and dispatched
    round-robin, so the stream is the same for any `num_workers` and
    `worker_type` ("process": spawned processes, the default for more than
    one worker; "thread": threads of this process). Each worker decodes on
    cpu_count // num_workers threads.

    Process workers unpickle the datasets (HDF5 files reopen lazily in each
    process), so a script that iterates this loader keeps its entry point
    under `if __name__ == "__main__":`, and what the datasets hold must
    pickle. With `shared_memory` the image plane of each batch crosses
    through a per-worker ring of shared-memory slots instead of the queue.

    With `parallel` (a process group's `DataParallel`) the plans are the
    node's batches of `batchsize` frames, the loader packs this rank's rows
    of each (`local_rows` of its place on the node), and every batch is
    padded as the ranks agree (`_agreed_padding`).

    `jpeg_decode` ("host" or "device", `pack_fused_batch`) is resolved once
    (`$NNTC_NO_NATIVE` turns "device" into "host") and printed; in "device"
    mode the entropy decoder is built here, before any worker starts, and
    the batches hold JPEG payloads that `device_prefetch` and
    `device_prefetch_stacked` decode on the card (K4). A batch with a frame
    that is not an undecoded JPEG (another dataset mixed in) is decoded on
    the host all the same, as the JAX loader does; `host_decoded_batches`
    counts such batches, and the first one is printed.
    """

    def __init__(
        self,
        concat_dataset,
        tags_by_dataset_index: Callable[[int], Any],
        tag_to_id: Dict[Any, int],
        sampler: Iterable[int],
        batchsize: int,
        pad_size: int,
        dataset_weight_by_index: Optional[Callable[[int], float]] = None,
        prefetch: int = 4,
        num_workers: int = 0,
        worker_type: str = "auto",
        shared_memory: bool = True,
        parallel: Optional[DataParallel] = None,
        jpeg_decode: str = "host",
    ):
        assert worker_type in ("auto", "thread", "process"), worker_type
        self.jpeg_decode = decode_mode(jpeg_decode)
        if self.jpeg_decode == "device":
            get_lib()  # a build failure raises here, not in a worker
            print("loader: JPEG decode on the card (host entropy decode, then K4)")
        else:
            print("loader: JPEG decode by cv2 on the host"
                  + (" ($NNTC_NO_NATIVE is set)" if jpeg_decode == "device" else ""))
        self.host_decoded_batches = 0
        self.parallel = parallel or DataParallel()
        self.rows = None
        if self.parallel.active:
            self.rows = local_rows(batchsize, self.parallel.local_rank, self.parallel.local_ranks)
        self.ds = concat_dataset
        self.tag_to_id = tag_to_id
        self.sampler = sampler
        self.batchsize = batchsize
        self.pad_size = pad_size
        self.shared_memory = bool(shared_memory)
        self.num_workers = max(1, int(num_workers))
        self.prefetch = max(prefetch, 2 * self.num_workers)
        self.worker_type = worker_type if worker_type != "auto" else ("process" if self.num_workers > 1 else "thread")
        # the per-dataset tables are made now, so that no callable has to cross into a worker process
        n_ds = len(self.ds.datasets)
        self._tags = [tags_by_dataset_index(i) for i in range(n_ds)]
        self._weights = [1.0 if dataset_weight_by_index is None else float(dataset_weight_by_index(i))
                         for i in range(n_ds)]

    def plan_batches(self, start: int = 0) -> Iterator[BatchPlan]:
        """The plans of the sampler's stream, from the `start`-th on."""
        plans = plan_batches(self.ds, self._tags.__getitem__, self.tag_to_id, self.sampler, self.batchsize,
                             self._weights.__getitem__)
        return itertools.islice(plans, start, None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate()

    def iterate(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The batches from the `start`-th on (a resumed run's step: the
        skipped plans load nothing)."""
        plans = self.plan_batches(start)
        if self.worker_type == "process":
            batches = self._iter_process_workers(plans)
        else:
            batches = self._iter_thread_workers(plans)
        if self.jpeg_decode == "device":
            batches = self._count_host_decoded(batches)
        return _agreed_padding(batches, self.parallel) if self.parallel.active else batches

    def _count_host_decoded(self, batches: Iterator[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
        """`batches`, counting in `host_decoded_batches` those that hold
        decoded images in "device" mode; the first is printed."""
        try:
            for batch in batches:
                if not isinstance(batch["image"], JpegCoefficients):
                    self.host_decoded_batches += 1
                    if self.host_decoded_batches == 1:
                        print("loader: a batch holds frames that are not undecoded JPEGs, so it is decoded on the "
                              "host (FusedBatchLoader.host_decoded_batches counts such batches)")
                yield batch
        finally:
            batches.close()

    def _decode_threads(self) -> int:
        return max(1, (os.cpu_count() or 1) // self.num_workers)

    def _iter_thread_workers(self, plans) -> Iterator[Dict[str, np.ndarray]]:
        W = self.num_workers
        decode_threads = self._decode_threads()
        per_worker = max(2, self.prefetch // W)
        in_qs = [queue.Queue(maxsize=per_worker) for _ in range(W)]
        out_qs = [queue.Queue(maxsize=per_worker) for _ in range(W)]
        stop = object()
        # the sampler is usually infinite: the threads end with the generator
        cancel = threading.Event()
        feeder_error = [None]

        def put_with_cancel(q, item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            w = 0
            try:
                for plan in plans:
                    if not put_with_cancel(in_qs[w], plan):
                        return
                    w = (w + 1) % W
            except Exception as e:  # noqa: BLE001 - a sampler's error reaches the consumer
                feeder_error[0] = e
            finally:
                for q in in_qs:
                    put_with_cancel(q, stop)

        def worker(wi):
            try:
                while not cancel.is_set():
                    try:
                        plan = in_qs[wi].get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if plan is stop:
                        put_with_cancel(out_qs[wi], stop)
                        return
                    put_with_cancel(out_qs[wi], _produce_batch(self.ds, plan, self.batchsize, self.pad_size,
                                                               decode_threads, self.rows, self.jpeg_decode))
            except Exception as e:  # noqa: BLE001 - forwarded to the consumer
                put_with_cancel(out_qs[wi], e)

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(W)]
        for t in threads:
            t.start()

        def cleanup():
            cancel.set()
            for t in threads:
                t.join(timeout=5)

        atexit.register(cleanup)
        try:
            w = 0
            while True:
                item = out_qs[w].get()
                if item is stop:  # dispatch and read-back share the order: after the last batch
                    if feeder_error[0] is not None:
                        raise feeder_error[0]
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
                w = (w + 1) % W
        finally:
            cleanup()
            atexit.unregister(cleanup)

    def _iter_process_workers(self, plans) -> Iterator[Dict[str, np.ndarray]]:
        import multiprocessing as mp
        from multiprocessing import shared_memory

        ctx = mp.get_context("spawn")
        W = self.num_workers
        per_worker = max(2, self.prefetch // W)
        in_qs = [ctx.Queue(maxsize=per_worker) for _ in range(W)]
        out_qs = [ctx.Queue(maxsize=per_worker) for _ in range(W)]
        shm_slots = per_worker + 3
        shms = []
        if self.shared_memory:
            stride = shm_slot_bytes(self.batchsize, self.pad_size, self.jpeg_decode)
            shms = [shared_memory.SharedMemory(create=True, size=stride * shm_slots) for _ in range(W)]
        procs = [
            ctx.Process(
                target=_process_worker_main,
                args=(self.ds, in_qs[i], out_qs[i], self.batchsize, self.pad_size, self._decode_threads(),
                      os.getpid(), shms[i].name if shms else None, shm_slots, self.rows, self.jpeg_decode),
                daemon=True,
            )
            for i in range(W)
        ]
        # the children inherit the environment at start(): none of them may see the card
        prev = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for p in procs:
                p.start()
        finally:
            if prev is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = prev

        cancel = threading.Event()
        done_feeding = threading.Event()
        sent, received = [0] * W, [0] * W
        feeder_error = [None]

        def feeder():
            w = 0
            try:
                for plan in plans:
                    while not cancel.is_set():
                        try:
                            in_qs[w].put(plan, timeout=0.1)
                            sent[w] += 1
                            break
                        except queue.Full:
                            continue
                    if cancel.is_set():
                        return
                    w = (w + 1) % W
            except Exception as e:  # noqa: BLE001 - a sampler's error reaches the consumer
                feeder_error[0] = e
            finally:
                done_feeding.set()
                for q in in_qs:
                    try:
                        q.put(None, timeout=5)
                    except Exception:  # noqa: BLE001 - a worker already gone
                        pass

        feeder_t = threading.Thread(target=feeder, daemon=True)
        feeder_t.start()
        # batches copied out of the ring by the reader thread, ahead of the consumer
        ready: "queue.Queue[Any]" = queue.Queue(maxsize=2)
        end = object()

        def cleanup():
            cancel.set()
            if reader_t.is_alive():
                reader_t.join(timeout=5)  # out of the ring before the ring goes
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
            for q in in_qs + out_qs:
                q.cancel_join_thread()
                q.close()
            for s in shms:
                try:
                    s.close()
                    s.unlink()
                except Exception:  # noqa: BLE001 - already released
                    pass

        def unpack(w, item):
            if not (isinstance(item, tuple) and len(item) == 6 and item[0] == "shm"):
                return item
            _, slot, seq, layout, pad, batch = item
            offset = slot * (shms[w].size // shm_slots)
            stamp = np.ndarray((), np.int64, buffer=shms[w].buf, offset=offset)
            if int(stamp) != seq:
                raise RuntimeError(f"shm ring lapped: worker {w} slot {slot} holds seq {int(stamp)}, expected {seq}")
            # copied out before the slot can be rewritten, into memory that device_prefetch uploads as it is
            arrays = []
            for off, shape, dtype in layout:
                arrays.append(_host_array(shape, dtype))
                arrays[-1][...] = np.ndarray(shape, np.dtype(dtype), buffer=shms[w].buf, offset=offset + _SHM_ALIGN + off)
            batch["image"] = arrays[0] if pad is None else JpegCoefficients(*arrays, pad)
            if int(stamp) != seq:
                raise RuntimeError(f"shm ring lapped during the copy: worker {w} slot {slot} now holds seq "
                                   f"{int(stamp)}, expected {seq}")
            return batch

        def hand_on(item) -> bool:
            while not cancel.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def read():
            """The workers' batches in dispatch order, each copied out of its
            ring slot (off the consumer's thread), then the end or the error."""
            w = 0
            try:
                while not cancel.is_set():
                    try:
                        item = out_qs[w].get(timeout=0.2)
                    except queue.Empty:
                        if done_feeding.is_set() and received[w] >= sent[w] and not feeder_t.is_alive():
                            hand_on(end if feeder_error[0] is None else feeder_error[0])
                            return
                        if not procs[w].is_alive():
                            raise RuntimeError(f"loader worker {w} died (exit {procs[w].exitcode})")
                        continue
                    received[w] += 1
                    if isinstance(item, Exception):
                        raise item
                    if not hand_on(unpack(w, item)):
                        return
                    w = (w + 1) % W
            except Exception as e:  # noqa: BLE001 - forwarded to the consumer
                hand_on(e)

        reader_t = threading.Thread(target=read, daemon=True)
        atexit.register(cleanup)
        reader_t.start()
        try:
            while True:
                try:
                    item = ready.get(timeout=0.2)
                except queue.Empty:
                    if not reader_t.is_alive() and ready.empty():
                        raise RuntimeError("the loader's reader thread ended without a batch or an error")
                    continue
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cleanup()
            atexit.unregister(cleanup)


class StackedBatch(dict):
    """A group of K batches stacked on a leading axis, on the device, with
    `host`: the pinned host tensors it was uploaded from, for the reads a
    step's host part makes (K1's plan reads the ROIs) without waiting for
    the device. A JPEG payload's arrays are not kept there: the images exist
    only on the device."""

    def __init__(self, fields: Dict[str, torch.Tensor], host: Dict[str, torch.Tensor]):
        super().__init__(fields)
        self.host = host


def _to_device(value, dev: torch.device) -> torch.Tensor:
    """A pinned field on `dev`, copied `non_blocking` on the current stream; a
    JPEG payload uploaded and decoded by K4 on that stream; a list of K
    planes or payloads (a stacked "image") into one (K, ...) tensor."""
    if isinstance(value, JpegCoefficients):
        return value.to(dev, non_blocking=True).decode()
    if isinstance(value, list):
        out = torch.empty((len(value),) + tuple(value[0].shape), dtype=torch.uint8, device=dev)
        for k, v in enumerate(value):
            if tuple(v.shape) != tuple(value[0].shape):
                raise ValueError(f"batch {k} of a group has images of shape {tuple(v.shape)}, the first "
                                 f"{tuple(value[0].shape)}")
            if isinstance(v, JpegCoefficients):
                v.to(dev, non_blocking=True).decode(out=out[k])
            else:
                out[k].copy_(v, non_blocking=True)
        return out
    return value.to(dev, non_blocking=True)


def _upload_ahead(pinned_items: Iterator[Dict[str, Any]], dev: torch.device, size: int, keep_host: bool):
    """The dicts of pinned host tensors of `pinned_items` on the card, each
    uploaded `non_blocking` on a side stream `size` items ahead of the
    consumer, JPEG payloads decoded there by K4 after their upload; the
    consuming stream waits on the side stream's event, recorded after the
    last copy and launch, and each tensor is marked as used by it
    (`record_stream`), so that the caching allocator does not hand its
    memory out while the consumer still reads it."""
    stream = torch.cuda.Stream(dev)

    def upload(pinned):
        with torch.cuda.stream(stream):
            out = {k: _to_device(v, dev) for k, v in pinned.items()}
            done = torch.cuda.Event()
            done.record(stream)
        if keep_host:
            out = StackedBatch(out, {k: v for k, v in pinned.items() if isinstance(v, torch.Tensor)})
        return out, done

    buf = collections.deque(upload(p) for p in itertools.islice(pinned_items, size))
    while buf:
        out, done = buf.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        nxt = next(pinned_items, None)
        if nxt is not None:
            buf.append(upload(nxt))
        yield out


def _pinned(src):
    """`src` in pinned host memory: as it is where it lies there already
    (the shared-memory ring's copies), else copied."""
    if isinstance(src, JpegCoefficients):
        return src.pinned()
    src = torch.as_tensor(src)
    if src.is_pinned():
        return src
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned


def _on_cpu_device(value, dev: torch.device) -> torch.Tensor:
    """A host field as a tensor on `dev` (not a card); a JPEG payload decoded
    there by K4's plain version."""
    if isinstance(value, JpegCoefficients):
        return value.to(dev).decode()
    return torch.as_tensor(value).to(dev)


def device_prefetch(iterator: Iterable[Dict[str, Any]], device: DeviceLike = None, size: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """The batches of `iterator` as tensors on `device` (default: the card),
    `size` batches ahead of the consumer.

    On a card each host batch is copied into pinned memory when it arrives
    (the loader may then reuse its buffers) and uploaded as `_upload_ahead`
    says. On the CPU it is a plain conversion to tensors. A JPEG payload
    under "image" becomes the padded uint8 batch (K4; its plain version on
    the CPU)."""
    dev = resolve_device(device)
    it = iter(iterator)
    try:
        if dev.type != "cuda":
            for batch in it:
                yield {k: _on_cpu_device(v, dev) for k, v in batch.items()}
            return
        yield from _upload_ahead(({k: _pinned(v) for k, v in b.items()} for b in it), dev, size, keep_host=False)
    finally:
        if hasattr(it, "close"):  # a loader's workers end with its iterator
            it.close()


def _groups(it: Iterator, k: int) -> Iterator[list]:
    """Consecutive groups of `k` items; a trailing group smaller than `k` is dropped."""
    while True:
        group = list(itertools.islice(it, k))
        if len(group) < k:
            return
        yield group


def stack_batches(iterator: Iterable[Dict[str, Any]], steps_per_dispatch: int) -> Iterator[Dict[str, torch.Tensor]]:
    """Groups of `steps_per_dispatch` batches of `iterator` (tensors on any
    one device, e.g. `iterate_fused_batches`'s), each field stacked on a
    leading axis where the batches lie; a trailing smaller group is dropped."""
    for group in _groups(iter(iterator), int(steps_per_dispatch)):
        yield {k: torch.stack([torch.as_tensor(b[k]) for b in group]) for k in group[0]}


def device_prefetch_stacked(iterator: Iterable[Dict[str, Any]], device: DeviceLike = None,
                            steps_per_dispatch: int = 2, size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Like `device_prefetch`, but groups `steps_per_dispatch` host batches
    into one stacked batch (leading dims (K, B, ...)) for the multi-step
    dispatch (`PoseTrainer.train_step_multi`). A trailing group smaller than
    K is dropped (the sampler streams are infinite in training; only bounded
    runs reach it). On a card the K batches are copied into one pinned
    tensor per field and uploaded as `device_prefetch` uploads, and each
    group is a `StackedBatch` that keeps its pinned host tensors; the images
    are uploaded batch by batch from their own pinned memory into row k of
    the group's (K, B, pad, pad, 1) image tensor, and a JPEG payload is
    decoded there by K4."""
    dev = resolve_device(device)
    k = int(steps_per_dispatch)
    it = iter(iterator)

    def pinned_group(group):
        out = {}
        for name in group[0]:
            if name == "image":
                out[name] = [_pinned(b[name]) for b in group]
                continue
            first = torch.as_tensor(group[0][name])
            out[name] = torch.empty((k,) + tuple(first.shape), dtype=first.dtype, pin_memory=True)
            for i, b in enumerate(group):
                out[name][i].copy_(torch.as_tensor(b[name]))
        return out

    try:
        if dev.type != "cuda":
            for group in _groups(it, k):
                yield {n: torch.stack([_on_cpu_device(b[n], dev) for b in group]) for n in group[0]}
            return
        yield from _upload_ahead((pinned_group(g) for g in _groups(it, k)), dev, size, keep_host=True)
    finally:
        if hasattr(it, "close"):
            it.close()


def iterate_fused_batches(
    packed: Dict[str, Any], batchsize: int, sampler: Iterable[int], device=None, start: int = 0,
    rows: Optional[slice] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of `batchsize` frames from a packed set (one fused batch dict
    of all frames), held on `device` (default: the card), in the order of
    `sampler`'s indices into the set, as the training CLI's sampler gives
    them: `make_concat_dataset_item_sampler(ConcatDataset([frames]), [1.0],
    seed=seed)`. With `start`, the first batch is the one an iterator of an
    equal sampler gives after `start` batches (a resumed run's step): the
    first `start * batchsize` indices of the stream are skipped. With `rows`
    (a data-parallel rank's `local_rows`), only those rows of each batch,
    `param_index` in the batch's row numbers."""
    dev = resolve_device(device)
    data = {k: torch.as_tensor(v).to(dev) for k, v in packed.items()}
    n = data["tag_id"].shape[0]
    if n < batchsize:
        raise ValueError(f"{n} frames make no batch of {batchsize}")
    it = iter(sampler)
    for _ in itertools.islice(it, start * batchsize):
        pass
    while True:
        indices = list(itertools.islice(it, batchsize))
        if len(indices) < batchsize:
            return
        rows_here = slice(None) if rows is None else rows
        idx = torch.as_tensor(indices[rows_here], dtype=torch.int64).to(dev)
        batch = {k: v.index_select(0, idx) for k, v in data.items()}
        batch["param_index"] = torch.arange(batchsize, dtype=torch.int32, device=dev)[rows_here]
        yield batch
