"""PyTorch/CUDA port of the NeuralNet-tracker training code.

The package mirrors `neuralnet_tracker_traincode_tpu` module for module, in
PyTorch idiom (`nn.Module`s, explicit `device`, explicit `torch.Generator`s).
It imports nothing of the JAX package: the JAX package is the reference the
port is tested against (`tests/test_torch_*.py`).

The augmentation kernels that were Pallas TPU kernels are hand-written CUDA
kernels for Hopper (`kernels/csrc/`), built at first use. Entry points run on
the CUDA device unless the caller passes `device="cpu"`; on the CPU the kernel
wrappers take their plain PyTorch versions.

Ported so far: the pose-estimator training run (every backbone and head of
the training CLI, every loss option, the full training augmentation, SWA,
validation, the epoch loop, model checkpoints in the JAX package's file
layout and resumable training states), the eval path (the Predictor's crop,
f32 forward and backtransform, the metrics, the rotation alignments and the
evaluation table), the face localizer, the host loader (HDF5 datasets, JPEG
decoding, `FusedBatchLoader` with thread or process workers, the upload to
the card) and the four training and evaluation CLIs (`scripts/`). What
waits is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
