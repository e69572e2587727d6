"""Drop frames or whole sequences from a pose HDF5 file (counterpart of the
JAX package's `scripts/filter_dataset.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.filter_dataset SOURCE.h5 DEST.h5 3,7,12 [--frames]

Host only: h5py is imported inside `main`.
"""

import argparse
import sys
from typing import List, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.utils import copy_attributes


def _generate_frame_mask(sequence_picks, old_sequence_starts):
    mask = np.zeros((old_sequence_starts[-1],), dtype="?")
    new_sequence_start = np.empty(len(sequence_picks) + 1, dtype=np.int64)
    n = 0
    last_end = 0
    for k, i in enumerate(sequence_picks):
        start, end = old_sequence_starts[i], old_sequence_starts[i + 1]
        assert end > start
        assert start >= last_end
        mask[start:end] = True
        new_sequence_start[k] = n
        n += end - start
        last_end = end
    new_sequence_start[-1] = n
    return mask, new_sequence_start


def _prepare_good_indices(total, good_indices, bad_indices):
    assert (good_indices is None) != (bad_indices is None)
    if bad_indices is not None:
        good_indices = np.setdiff1d(np.arange(total), np.asarray(bad_indices))
    return np.sort(np.asarray(good_indices))


def filter_file_by_sequences(f, fout, good_sequences_indices=None, bad_sequence_indices=None):
    sequence_starts = np.array(f["sequence_starts"][...])
    good = _prepare_good_indices(
        total=sequence_starts.shape[0] - 1,
        good_indices=good_sequences_indices,
        bad_indices=bad_sequence_indices,
    )
    N = sequence_starts[-1]
    mask, new_sequence_start = _generate_frame_mask(good, sequence_starts)
    for name, ds in f.items():
        if name == "sequence_starts":
            fout.create_dataset(name, data=new_sequence_start)
        elif ds.shape[0] == N:
            (idx,) = np.nonzero(mask)
            new_ds = fout.create_dataset(name, data=ds[idx, ...])
            copy_attributes(ds, new_ds)
        else:
            raise AssertionError(f"Dataset {name} length {ds.shape[0]} != frame count {N}")


def filter_file_by_frames(f, fout, *, good_frame_indices=None, bad_frame_indices=None):
    assert "sequence_starts" not in f, "Use filter_file_by_sequences for sequence files"
    frame_count = next(iter(f.values())).shape[0]
    indices = _prepare_good_indices(frame_count, good_frame_indices, bad_frame_indices)
    for name, ds in f.items():
        assert ds.shape[0] == frame_count, f"Dataset {name} has inconsistent length"
        new_ds = fout.create_dataset(name, data=ds[indices, ...])
        copy_attributes(ds, new_ds)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Remove sequences")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str)
    parser.add_argument("bad", help="Indices of bad sequences, comma separated.", type=str)
    parser.add_argument("--frames", action="store_true", help="Indices denote frames instead of sequences")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import h5py

    bad = [int(s.strip()) for s in args.bad.split(",")]
    assert args.source != args.destination
    with h5py.File(args.source, "r") as f, h5py.File(args.destination, "w") as fout:
        if args.frames:
            print(f"Filtering {len(bad)} frames")
            filter_file_by_frames(f, fout, bad_frame_indices=bad)
        else:
            print(f"Filtering {len(bad)} sequences")
            filter_file_by_sequences(f, fout, bad_sequence_indices=bad)
    return 0


if __name__ == "__main__":
    sys.exit(main())
