"""Full training-state checkpoints for resuming a run (counterpart of the JAX
package's `train/checkpointing.py`, in the port's own format).

A file is an 8-byte little-endian header length, a JSON header
`{"format", "extra"}` and a `torch.save` blob of: the model's state dict
(parameters and buffers), the step, Adam's count and moments, the SWA
averages and their count, and the state of the augmentation's
`torch.Generator` when one is given. It is written to a temporary name and
moved into place with `os.replace`, so a killed run never leaves half a file.
Loading it into a freshly built trainer continues the run bit for bit.
Loading copies into the tensors the run already has (the model's, and the
Adam moments and count of the state it is given), so that a CUDA graph
captured over them stays valid; Adam's count is stored as an int.
"""

import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from neuralnet_tracker_traincode_torch.train.loop import AdamState, PoseTrainer, TrainState

FORMAT = "nntt-torch-train-state-1"


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_train_state(
    trainer: PoseTrainer,
    state: TrainState,
    filename: str,
    extra: Optional[Dict[str, Any]] = None,
    generator: Optional[torch.Generator] = None,
):
    payload = {
        "model": _cpu(trainer.model.state_dict()),
        "step": state.step,
        "adam": {"count": int(state.opt_state.count), "mu": _cpu(state.opt_state.mu), "nu": _cpu(state.opt_state.nu)},
        "swa": {"params": _cpu(state.swa_params), "buffers": _cpu(state.swa_buffers), "count": state.swa_count},
        "generator": None if generator is None else generator.get_state(),
    }
    blob = io.BytesIO()
    torch.save(payload, blob)
    header = json.dumps({"format": FORMAT, "extra": extra or {}}).encode("utf-8")
    tmp = filename + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(blob.getbuffer())
    os.replace(tmp, filename)


def load_train_state(
    trainer: PoseTrainer, filename: str, generator: Optional[torch.Generator] = None,
    state: Optional[TrainState] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Load the model's weights in place and return (state, extra); restores
    `generator` when the file holds a generator state. With `state`, its
    Adam moments and count take the file's values in place."""
    with open(filename, "rb") as f:
        hdr_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hdr_len).decode("utf-8"))
        if header.get("format") != FORMAT:
            raise ValueError(f"{filename} is not a training state of this package ({header.get('format')!r})")
        payload = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(payload["model"])
    dev = trainer.device
    on = lambda tree: {k: v.to(dev) for k, v in tree.items()}  # noqa: E731
    adam, swa = payload["adam"], payload["swa"]
    if state is None:
        opt_state = AdamState(torch.tensor(int(adam["count"]), dtype=torch.int32, device=dev),
                              on(adam["mu"]), on(adam["nu"]))
    else:
        opt_state = state.opt_state
        with torch.no_grad():
            opt_state.count.fill_(int(adam["count"]))
            for mine, theirs in ((opt_state.mu, adam["mu"]), (opt_state.nu, adam["nu"])):
                if set(mine) != set(theirs):
                    raise ValueError(f"{filename}: the Adam moments are of other parameters")
                for k, v in theirs.items():
                    mine[k].copy_(v)
    state = TrainState(
        step=int(payload["step"]),
        opt_state=opt_state,
        swa_params=on(swa["params"]),
        swa_buffers=on(swa["buffers"]),
        swa_count=int(swa["count"]),
    )
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"])
    return state, header.get("extra", {})
