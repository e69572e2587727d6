"""Concatenate pose HDF5 files, re-offsetting `sequence_starts`
(counterpart of the JAX package's `scripts/dsjoin.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsjoin DEST.h5 SOURCE.h5 [SOURCE.h5 ...]

Groups are joined recursively, datasets copied in batches (variable-length
ones too), attributes kept, `sequence_starts` merged with cumulative
offsets. Host only: h5py is imported inside the functions.
"""

import argparse
import sys
from contextlib import ExitStack
from typing import Any, List, Optional, Sequence

import numpy as np

from neuralnet_tracker_traincode_torch.utils import copy_attributes

_COPY_BATCH = 1024


def _batched_copy(dst, src, dst_offset: int):
    n = src.shape[0]
    for a in range(0, n, _COPY_BATCH):
        b = min(n, a + _COPY_BATCH)
        dst[a + dst_offset : b + dst_offset, ...] = src[a:b, ...]


def concatenating_join(name: str, items: Sequence[Any], fout):
    first = items[0]
    sizes = [ds.shape[0] for ds in items]
    total = sum(sizes)
    print(f"Copying {name}: {sizes} items of type {first.dtype}")
    assert all(
        list(first.attrs.items()) == list(ds.attrs.items()) for ds in items
    ), f"Attribute mismatch among sources of {name}"
    dst = fout.create_dataset_like(name, first, shape=(total, *first.shape[1:]), maxshape=(total, *first.shape[1:]))
    copy_attributes(first, dst)
    offset = 0
    for src, count in zip(items, sizes):
        _batched_copy(dst, src, offset)
        offset += count


def join_sequence_starts(name: str, items: Sequence[Any], fout):
    starts = [np.asarray(items[0][:1])]
    for ds in items:
        current = starts[-1][-1]
        starts.append(np.asarray(ds[...][1:]) + current)
    starts = np.concatenate(starts)
    print(f"Joining sequence_starts `{name}`: {[ds.shape[0] for ds in items]} entries; new sample count {starts[-1]}")
    fout.create_dataset(name, data=starts)


def dsjoin(grps: Sequence[Any], fout):
    """Join the h5py groups `grps` into the group `fout`."""
    import h5py

    first = grps[0]
    assert all(g.keys() == first.keys() for g in grps), "Source files disagree on datasets"
    for name in first.keys():
        items = [g[name] for g in grps]
        if isinstance(items[0], h5py.Dataset):
            assert all(isinstance(i, h5py.Dataset) for i in items)
            if name == "sequence_starts":
                join_sequence_starts(name, items, fout)
            else:
                concatenating_join(name, items, fout)
        else:
            assert all(isinstance(i, h5py.Group) for i in items)
            dsjoin(items, fout.create_group(name))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Join datasets")
    parser.add_argument("destination", help="destination file")
    parser.add_argument("sources", help="source files", type=str, nargs="+")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import h5py

    with ExitStack() as stack:
        files = [stack.enter_context(h5py.File(fn, "r")) for fn in args.sources]
        with h5py.File(args.destination, "w") as fout:
            dsjoin(files, fout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
