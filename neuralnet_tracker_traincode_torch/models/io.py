"""Self-describing model checkpoints, in the JAX package's file layout.

Counterpart of the JAX package's `models/io.py`. A file is:

    b"NNTTPU1\\n" | header length (8 bytes, little endian) | JSON header
    {"class_name", "config"} | msgpack blob of the flax variables tree

The blob holds `{"params", "batch_stats"}` in the flax layout (written and
read through `models/weights.py`'s bridge, by the port's own msgpack codec),
so the JAX package's `load_model` reads a file the port wrote, and the port
reads the JAX package's: a model trained here is evaluated and exported by
the JAX package's tools. Both classes of the JAX package's files are read
and written: `NetworkWithPointHead` and `LocalizerNet`.
"""

import json
from typing import Dict, List, Optional, Type

import torch

from neuralnet_tracker_traincode_torch.models import msgpack_codec
from neuralnet_tracker_traincode_torch.models.weights import (
    localizer_state_dict_from_jax,
    localizer_variables_to_jax,
    posenet_state_dict_from_jax,
    posenet_variables_to_jax,
)

MAGIC = b"NNTTPU1\n"


class InvalidFileFormatError(RuntimeError):
    pass


def save_model(model: torch.nn.Module, state_dict: Optional[Dict[str, torch.Tensor]], filename: str):
    """Write `model`'s class and config with `state_dict` (default: the
    model's own) as its variables."""
    name = type(model).__name__
    if name not in ("NetworkWithPointHead", "LocalizerNet"):
        raise InvalidFileFormatError(f"No checkpoint layout for {name}")
    config = model.get_config()
    sd = model.state_dict() if state_dict is None else state_dict
    variables = localizer_variables_to_jax(sd) if name == "LocalizerNet" else posenet_variables_to_jax(sd, config)
    blob = msgpack_codec.packb(variables)
    header = json.dumps({"class_name": type(model).__name__, "config": config}).encode("utf-8")
    with open(filename, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(blob)


def read_model_file(filename: str):
    """(header, variables tree) of a checkpoint file."""
    with open(filename, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise InvalidFileFormatError(f"Bad magic in {filename}")
        hdr_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hdr_len).decode("utf-8"))
        blob = f.read()
    return header, msgpack_codec.unpackb(blob)


def load_model(filename: str, classes: List[Type]) -> torch.nn.Module:
    """The module the file describes, its weights loaded (on the CPU, f32,
    in eval mode). The JAX package returns the module and its variables; a
    PyTorch module holds its own."""
    header, variables = read_model_file(filename)
    class_by_name = {c.__name__: c for c in classes}
    name = header["class_name"]
    if name not in class_by_name:
        raise InvalidFileFormatError(f"Unknown model class {name}; known: {list(class_by_name)}")
    config = dict(header["config"])
    model = class_by_name[name](**config)
    if name == "LocalizerNet":
        model.load_state_dict(localizer_state_dict_from_jax(variables))
    else:
        model.load_state_dict(posenet_state_dict_from_jax(variables, config))
    return model.eval()


def load_posenet(filename: str) -> torch.nn.Module:
    """Load a pose network or localizer checkpoint, as the JAX package's
    `load_posenet` does."""
    from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead

    return load_model(filename, [NetworkWithPointHead, LocalizerNet])
