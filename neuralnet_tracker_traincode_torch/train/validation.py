"""Validation during training (counterpart of the JAX package's
`train/validation.py`): the deterministic crop, an eval-mode forward and the
training criterion over a held-out set.

The set is packed once: padded to 64 * ceil(largest side / 64), cut into
batches of `batchsize`, the last one filled up by repeating its first frame
at `dataset_weight` 0. A frame's tag id is its tag's row in the trainer's
criterion (`train/run.py:setup_losses(..., validation_tags=...)` adds the
validation set's tags there), not its place in the training mixture. Each
batch takes the training augmentation in its deterministic form (K1 with
`skip_rotation`, no flip, no intensity stages), so validation launches K1 at
its own shapes. The loss is the mean of the
batches' criterion losses; each term, the mean over the batches of its sum
over the frames with nonzero weight divided by their count. Everything stays
on the device until `run` returns.
"""

from typing import Dict, List

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.augmentation.pipeline import augment_batch_for_training
from neuralnet_tracker_traincode_torch.data.loader import pack_fused_batch
from neuralnet_tracker_traincode_torch.train.loop import _NOT_LABELS, PoseTrainer
from neuralnet_tracker_traincode_torch.utils import ceil_to_multiple


class FusedValidation:
    def __init__(self, trainer: PoseTrainer, dataset, batchsize: int = 128):
        self.trainer = trainer
        self.batchsize = batchsize
        self.tag_to_id = trainer.criterion.tag_index
        self._batches = self._pack(dataset)

    def _pack(self, dataset) -> List[Dict[str, torch.Tensor]]:
        samples = [dataset[i] for i in range(len(dataset))]
        missing = {s.meta.tag for s in samples} - set(self.tag_to_id)
        if missing:
            raise ValueError(f"the criterion has no loss group for the validation tags {sorted(map(str, missing))}: "
                             "build it with setup_losses(options, tag_order, validation_tags=...)")
        pad = ceil_to_multiple(max(max(s.meta.image_wh) for s in samples))
        dev = self.trainer.device
        batches = []
        for i in range(0, len(samples), self.batchsize):
            chunk = samples[i : i + self.batchsize]
            b = pack_fused_batch(chunk, [self.tag_to_id[s.meta.tag] for s in chunk], pad)
            B = b["tag_id"].shape[0]
            if B % self.batchsize != 0:
                reps = self.batchsize - B
                b = {k: np.concatenate([v, np.repeat(v[:1], reps, axis=0)]) for k, v in b.items()}
                b["dataset_weight"][B:] = 0.0
            batches.append({k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        return batches

    @torch.no_grad()
    def evaluate(self, epoch: int) -> Dict[str, torch.Tensor]:
        """Device scalars: 'loss' and each term's mean, for the model's
        current weights and the criterion's weights at `epoch`."""
        trainer = self.trainer
        aug = trainer.config.aug._replace(deterministic=True)
        W = trainer.weight_matrix(epoch)
        model = trainer.model.eval()
        losses, terms = [], {}
        for b in self._batches:
            labels = {k: v for k, v in b.items() if k not in _NOT_LABELS}
            x, labels = augment_batch_for_training(b["image"], labels, trainer.categories, aug, device=trainer.device)
            out = model(x, coord_convention_id=labels.get("coord_convention_id"))
            loss, byname = trainer.criterion(out, labels, b["tag_id"], W, dataset_weight=b["dataset_weight"])
            losses.append(loss)
            for k, (vals, ws) in byname.items():
                terms.setdefault(k, []).append(vals.sum() / torch.clamp((ws != 0).sum(), min=1))
        return {"loss": torch.stack(losses).mean(), **{k: torch.stack(v).mean() for k, v in terms.items()}}

    def run(self, epoch: int, *recorders) -> float:
        """The validation loss of the model's current weights as a float (one
        transfer); each recorder gets a test point per metric."""
        metrics = self.evaluate(epoch)
        names = list(metrics)
        values = torch.stack([metrics[n] for n in names]).cpu().tolist()
        for rec in recorders:
            for n, v in zip(names, values):
                rec.add_test_point(epoch, n, v)
        return values[0]
