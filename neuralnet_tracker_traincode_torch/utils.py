"""Host-side helpers (the port's own copy of the parts of the JAX package's
`utils.py` that eval and the sampler need): the AFLW euler convention,
batching of an iterable, the padding bucket and `cycle`. numpy and scipy
only."""

import numpy as np
from scipy.spatial.transform import Rotation

rad2deg = 180.0 / np.pi


def convert_to_rot(net_output: np.ndarray) -> Rotation:
    return Rotation.from_quat(net_output)


_P = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float64)


def inv_aflw_rotation_conversion(rot: Rotation) -> np.ndarray:
    """Rotation -> (pitch, yaw, roll) euler angles of the AFLW convention,
    shape (..., 3)."""
    M = _P @ rot.as_matrix() @ _P.T
    return Rotation.from_matrix(M).as_euler("XYZ") * np.asarray([1.0, -1.0, 1.0])


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
