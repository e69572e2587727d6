"""HDF5 storage wrappers (the port's own copy of the JAX package's
`data/hdf5.py`): variable-length JPEG/PNG buffers, images in files beside
the HDF5 file, and min/max-quantized uint8 arrays of varying shape.

The schema is the JAX package's (the same `storage`, `lossy` and `category`
attributes), so either package reads the other's files. Every wrapper
returns numpy arrays. h5py is imported where a file is opened or a dataset
created: importing this module needs neither h5py nor cv2.

Decoding is cv2's, grayscale for monochrome sets. `RawJpegBuffer` holds a
JPEG undecoded, so that the loader decodes a whole batch on its own threads
(`data/loader.py:pack_fused_batch`).
"""

import threading
from functools import cached_property
from os.path import basename, dirname, isfile, join, splitext
from typing import List, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.data.preprocessing import ImageFormat, imdecode, imencode, which_image_format
from neuralnet_tracker_traincode_torch.utils import glob_hdf_datasets


def variable_length_hdf5_buffer_dtype():
    import h5py

    return h5py.special_dtype(vlen=np.dtype("uint8"))


class DatasetEncoding:
    varsize_array_buffer = "varsize_array_buffer"
    varsize_image_buffer = "varsize_image_buffer"
    image_filename = "image_filename"


def _chunk_shape(shape, maxshape):
    if shape is None:
        shape = maxshape
    n, rest = shape[0], shape[1:]
    return (min(1024, n),) + rest


def _ensure_image_color_mode(img: np.ndarray, monochrome: bool) -> np.ndarray:
    assert not monochrome or img.ndim == 2
    assert monochrome or (img.ndim == 3 and img.shape[-1] == 3)
    return img


class ImageDs:
    def __init__(self):
        self.monochrome = True

    def _decode(self, buffer):
        decoded = imdecode(buffer, color=False if self.monochrome else "rgb")
        return _ensure_image_color_mode(decoded, self.monochrome)

    def __getitem__(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


def jpeg_dimensions(buf):
    """(height, width) from the SOF marker of a JPEG buffer, or None."""
    b = memoryview(buf.tobytes() if isinstance(buf, np.ndarray) else buf)
    if len(b) < 4 or bytes(b[:2]) != b"\xff\xd8":
        return None
    i = 2
    while i + 9 < len(b):
        if b[i] != 0xFF:
            i += 1
            continue
        marker = b[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        length = (b[i + 2] << 8) | b[i + 3]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):  # SOFn
            return (b[i + 5] << 8) | b[i + 6], (b[i + 7] << 8) | b[i + 8]
        i += 2 + length
    return None


class RawJpegBuffer:
    """Undecoded JPEG bytes standing in for an (h, w, 1) image: enough of an
    array's surface (`shape`, `ndim`) for size probing, and `decode`."""

    __slots__ = ("buffer", "height", "width")

    ndim = 3

    def __init__(self, buffer: np.ndarray, height: int, width: int):
        self.buffer = buffer
        self.height = height
        self.width = width

    @property
    def shape(self):
        return (self.height, self.width, 1)

    def decode(self) -> np.ndarray:
        """(h, w, 1) uint8, decoded by cv2 in grayscale."""
        return _ensure_image_color_mode(imdecode(self.buffer, color=False), True)[..., None]


class ImageVariableLengthBufferDs(ImageDs):
    """Images stored as variable-length encoded JPEG (lossy) or PNG buffers."""

    def __init__(self, ds):
        super().__init__()
        if ds.attrs.get("lossy", True):
            self._format = ImageFormat.JPG
            self._encode = lambda value: imencode(value, format=ImageFormat.JPG, quality=95)
        else:
            self._format = ImageFormat.PNG
            self._encode = lambda value: imencode(value, format=ImageFormat.PNG)
        assert ds.attrs["storage"] == DatasetEncoding.varsize_image_buffer
        self.ds = ds

    def __getitem__(self, index: int):
        return self._decode(self.ds[index])

    def read_raw(self, index: int) -> np.ndarray:
        """The stored buffer, undecoded."""
        return np.asarray(self.ds[index])

    @property
    def is_jpeg(self) -> bool:
        return self._format == ImageFormat.JPG

    def __setitem__(self, index: int, value):
        from PIL import Image

        assert (isinstance(value, np.ndarray) and value.dtype == np.uint8) or isinstance(value, Image.Image)
        if isinstance(value, Image.Image):
            value = np.asarray(value)
        if len(value.shape) in (2, 3):
            value = self._encode(value)
        else:
            if which_image_format(value) != self._format:
                raise ValueError(
                    f"Buffer for lossy/lossless data must be encoded as jpg/png, got {which_image_format(value)}"
                )
            assert len(value.shape) == 1
        self.ds[index] = value

    def __len__(self):
        return len(self.ds)

    def resize(self, size, axis):
        return self.ds.resize(size, axis)

    @cached_property
    def attrs(self):
        return self.ds.attrs

    @staticmethod
    def create(g, name: str, size: int, maxsize: Optional[int] = None, lossy=True):
        ds = g.create_dataset(name, (size,), variable_length_hdf5_buffer_dtype(), maxshape=(maxsize,),
                              chunks=_chunk_shape((size,), (maxsize,)))
        ds.attrs["storage"] = DatasetEncoding.varsize_image_buffer
        ds.attrs["lossy"] = lossy
        return ImageVariableLengthBufferDs(ds)


class ImagePathDs(ImageDs):
    """Images in files named relative to the HDF5 file (in its directory, or
    in the directory named after it)."""

    def __init__(self, ds):
        super().__init__()
        assert ds.attrs["storage"] == DatasetEncoding.image_filename
        self._ds = ds
        self._filelist = ImagePathDs._find_filenames(ds)

    @staticmethod
    def _find_filenames(ds):
        supported_extensions = (".jpg", ".png", ".jpeg")
        names = ds[...]
        first = names[0].decode("ascii")
        extensions_to_try = supported_extensions if splitext(first.lower())[1] not in supported_extensions else ("",)
        directories_to_try = [dirname(ds.file.filename), splitext(ds.file.filename)[0]]
        for root_dir in directories_to_try:
            for ext in extensions_to_try:
                if isfile(join(root_dir, first + ext)):
                    return [join(root_dir, s.decode("ascii") + ext) for s in names]
        raise RuntimeError(
            f"Cannot find images for image path dataset. Looking for name {first} "
            f"with roots {directories_to_try} and extensions {extensions_to_try}"
        )

    def __getitem__(self, index: int):
        with open(self._filelist[index], "rb") as f:
            buffer = f.read()
        return self._decode(buffer)

    def __len__(self):
        return len(self._filelist)

    @cached_property
    def attrs(self):
        return self._ds.attrs

    @staticmethod
    def create(g, name, data):
        ds = g.create_dataset(name, data=data)
        ds.attrs["storage"] = DatasetEncoding.image_filename
        return ImagePathDs(ds)


def create_dataset(g, name, shape=None, dtype=None, maxshape=None, data=None):
    if data is not None:
        data = np.asarray(data)
        assert shape is None or data.shape == shape
    if shape is None:
        assert data is not None
        shape = data.shape
    return g.create_dataset(name, shape, dtype, chunks=_chunk_shape(shape, maxshape), maxshape=maxshape, data=data)


def _quantize(values: np.ndarray):
    assert values.dtype in (np.float32, np.float64)
    minval = np.amin(values, keepdims=True)
    maxval = np.amax(values, keepdims=True)
    buffer = ((values - minval) / (maxval - minval + 1.0) * 256).astype(np.uint8)
    return np.squeeze(minval), np.squeeze(maxval), buffer


def _dequantize(minval, maxval, buffer, shape):
    buffer = buffer / 256.0 * (maxval - minval + 1) + minval
    return buffer.astype(np.float32).reshape(shape)


class QuantizedVarsizeArrayDs:
    """Float arrays stored min/max-quantized to uint8, each with its shape."""

    def __init__(self, ds):
        assert ds.attrs["storage"] == DatasetEncoding.varsize_array_buffer
        self.ds = ds

    def __getitem__(self, index: int):
        shape, minval, maxval, buffer = self.ds[index]
        return _dequantize(minval, maxval, np.frombuffer(buffer, dtype=np.uint8), shape)

    def __setitem__(self, index: int, value: np.ndarray):
        minval, maxval, buffer = _quantize(value)
        self.ds[index] = (value.shape, float(minval), float(maxval), buffer.ravel())

    @cached_property
    def attrs(self):
        return self.ds.attrs

    def __len__(self):
        return len(self.ds)

    def resize(self, size, axis):
        return self.ds.resize(size, axis)

    @staticmethod
    def create(g, name, size, sample_dimensionality, maxsize=None):
        dt = np.dtype([
            ("shape", "i4", (sample_dimensionality,)),
            ("minval", "f4"),
            ("maxval", "f4"),
            ("buffer", variable_length_hdf5_buffer_dtype()),
        ])
        ds = g.create_dataset(name, (size,), chunks=_chunk_shape((size,), (maxsize,)), maxshape=(maxsize,), dtype=dt)
        ds.attrs["storage"] = DatasetEncoding.varsize_array_buffer
        return QuantizedVarsizeArrayDs(ds)


Whitelist = List[str]


def open_dataset(g, name: str):
    """The dataset `name` of group `g`, wrapped by its `storage` attribute
    (a plain h5py dataset where it has none)."""
    ds = g[name]
    if "storage" not in ds.attrs:
        return ds
    typeattr = ds.attrs["storage"]
    if typeattr == DatasetEncoding.varsize_array_buffer:
        return QuantizedVarsizeArrayDs(ds)
    if typeattr == DatasetEncoding.image_filename:
        return ImagePathDs(ds)
    if typeattr == DatasetEncoding.varsize_image_buffer:
        return ImageVariableLengthBufferDs(ds)
    raise RuntimeError(f"Unknown value of attribute 'storage': {typeattr}")


def open_all_datasets(root, whitelist: Whitelist):
    opened = [(basename(ds.name), open_dataset(root, ds.name)) for ds in glob_hdf_datasets(root, whitelist)]
    assert len(set(k for k, _ in opened)) == len(opened), "Dataset base names must be unique."
    return opened


class Hdf5DatasetBase:
    """Random access to the datasets of one HDF5 file.

    The file is (re)opened on first access, under a lock, and a pickled
    instance carries no handle: each worker process or thread opens its own.
    With `use_raw_images`, monochrome JPEG images come back as
    `RawJpegBuffer`s, undecoded.
    """

    use_raw_images = False

    def __init__(self, filename, monochrome=True, whitelist: Whitelist = None):
        import h5py

        self.monochrome = monochrome
        self.filename = filename
        self.whitelist = whitelist
        self._h5file = None
        self._names_datasets = None
        self._open_lock = threading.Lock()
        with h5py.File(self.filename, "r") as f:
            self._init_from_file(f, whitelist)

    def _init_from_file(self, f, whitelist: Whitelist):
        names_datasets = open_all_datasets(f, whitelist)
        lengths = [len(v) for _, v in names_datasets]
        assert lengths and all(n == lengths[0] for n in lengths), (
            f"Inconsistent lengths among data: {[k for k, v in names_datasets]}"
        )
        self._frame_count = lengths[0]
        return names_datasets

    @property
    def frame_count(self):
        return self._frame_count

    def __len__(self):
        return self.frame_count

    def _ensure_h5opened(self):
        # `_names_datasets` is published last, after the wrappers are set up:
        # the lock-free fast path trusts it as the ready signal
        if self._names_datasets is not None:
            return
        with self._open_lock:
            if self._names_datasets is not None:
                return
            import h5py

            h5file = h5py.File(self.filename, "r")
            names_datasets = dict(open_all_datasets(h5file, self.whitelist))
            for ds in names_datasets.values():
                if isinstance(ds, ImageDs):
                    ds.monochrome = self.monochrome
            self._h5file = h5file
            self._names_datasets = names_datasets

    def __getitem__(self, index):
        # bounded by the frames, not len(self): a video dataset's length counts its sequences
        if index < 0 or index >= self.frame_count:
            raise IndexError(f"Index {index} on dataset of {self.frame_count} frames")
        self._ensure_h5opened()
        out = []
        for name, dataset in self._names_datasets.items():
            if (self.use_raw_images and self.monochrome and isinstance(dataset, ImageVariableLengthBufferDs)
                    and dataset.is_jpeg):
                raw = dataset.read_raw(index)
                dims = jpeg_dimensions(raw)
                if dims is not None:
                    out.append((name, RawJpegBuffer(raw, dims[0], dims[1])))
                    continue
            out.append((name, np.asarray(dataset[index])))
        return out

    def close(self):
        with self._open_lock:
            if self._h5file is not None:
                self._h5file.close()
                self._h5file = None
                self._names_datasets = None

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_h5file"] = None
        state["_names_datasets"] = None
        state.pop("_open_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_lock = threading.Lock()
