"""Host-side helpers (the port's own copy of the JAX package's `utils.py`
but for its JAX compile-cache switch): the heading/pitch/bank and AFLW euler
conventions, 3D affine chains, batching of an iterable, the padding bucket,
`cycle`, the loader's worker count, file-name and dict-of-lists helpers and
the walk over an HDF5 file's datasets. numpy and scipy only; h5py is
imported where a file is walked."""

import fnmatch
import os
from os.path import splitext
from typing import Any, Dict, List

import numpy as np
from scipy.spatial.transform import Rotation

rad2deg = 180.0 / np.pi
deg2rad = np.pi / 180.0


def identity(arg):
    return arg


def as_hpb(rot: Rotation) -> np.ndarray:
    """Heading, pitch, bank (..., 3): an aeronautic-like convention, the
    extrinsic euler angles "YXZ"."""
    return rot.as_euler("YXZ")


def from_hpb(hpb) -> Rotation:
    return Rotation.from_euler("YXZ", hpb)


def convert_to_rot(net_output: np.ndarray) -> Rotation:
    return Rotation.from_quat(net_output)


_P = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float64)


def aflw_rotation_conversion(pitch, yaw, roll) -> Rotation:
    """AFLW / 300W-LP euler angles -> Rotation."""
    rot = Rotation.from_euler("XYZ", np.asarray([pitch, -np.asarray(yaw), roll]).T)
    return Rotation.from_matrix(_P @ rot.as_matrix() @ _P.T)


def inv_aflw_rotation_conversion(rot: Rotation) -> np.ndarray:
    """Rotation -> (pitch, yaw, roll) euler angles of the AFLW convention,
    shape (..., 3)."""
    M = _P @ rot.as_matrix() @ _P.T
    return Rotation.from_matrix(M).as_euler("XYZ") * np.asarray([1.0, -1.0, 1.0])


def affine3d_chain(Ta, Tb):
    """(R, t) of x -> Ta(Tb(x)) for (Rotation, translation) pairs."""
    Ra, ta = Ta
    Rb, tb = Tb
    return Ra * Rb, Ra.as_matrix().dot(tb) + ta


def affine3d_inv(Ta):
    Ra, ta = Ta
    RaInv = Ra.inv()
    return RaInv, -RaInv.as_matrix().dot(ta)


def iter_batched(iterable, batchsize):
    """Chunks of `batchsize`: slices of an array, else lists."""
    if isinstance(iterable, np.ndarray):
        for i in range(0, iterable.shape[0], batchsize):
            yield iterable[i : i + batchsize, ...]
        return
    it = iter(iterable)
    while True:
        ret = [x for _, x in zip(range(batchsize), it)]
        if not ret:
            break
        yield ret


def ceil_to_multiple(n: int, multiple: int = 64) -> int:
    """Round up to a multiple (the padding bucket of the packed batches and
    the Predictor)."""
    return int(-(-int(n) // multiple) * multiple)


def cycle(iterable):
    """Like itertools.cycle but without caching the first pass: each pass
    iterates `iterable` anew (a sampler draws a new permutation)."""
    iterator = iter(iterable)
    while True:
        try:
            yield next(iterator)
        except StopIteration:
            iterator = iter(iterable)
            try:
                yield next(iterator)
            except StopIteration:
                raise ValueError("cycle() over an empty iterable")


def replace_ext(filename, replacement):
    basename, _ = splitext(filename)
    return basename + replacement


def list_of_dicts_to_dict_of_lists(lod: List[Dict[Any, Any]]) -> Dict[Any, List[Any]]:
    if not lod:
        return {}
    return {k: [items[k] for items in lod] for k in lod[0].keys()}


def num_workers() -> int:
    """The loader's worker count: `$NUM_WORKERS`, default 4."""
    return int(os.environ.get("NUM_WORKERS", 4))


def copy_attributes(src, dst):
    for k, v in src.attrs.items():
        dst.attrs[k] = v


def iter_hdf_datasets(x):
    """Every dataset under an HDF5 group, depth first."""
    import h5py

    if isinstance(x, h5py.Group):
        for v in x.values():
            yield from iter_hdf_datasets(v)
    else:
        yield x


def glob_hdf_datasets(f, patterns: List[str]):
    """The datasets under `f` whose full name matches one of `patterns`."""
    for ds in iter_hdf_datasets(f):
        if any(fnmatch.fnmatch(ds.name, pattern) for pattern in patterns):
            yield ds
