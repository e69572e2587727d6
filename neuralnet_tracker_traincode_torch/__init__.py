"""PyTorch/CUDA port of the NeuralNet-tracker training code.

The package mirrors `neuralnet_tracker_traincode_tpu` module for module, in
PyTorch idiom (`nn.Module`s, explicit `device`, explicit `torch.Generator`s).
It imports nothing of the JAX package: the JAX package is the reference the
port is tested against (`tests/test_torch_*.py`).

The augmentation kernels that were Pallas TPU kernels are hand-written CUDA
kernels for Hopper (`kernels/csrc/`), built at first use. Entry points run on
the CUDA device unless the caller passes `device="cpu"`; on the CPU the kernel
wrappers take their plain PyTorch versions.

Every public module of the JAX package has its counterpart here: the
pose-estimator training run (every backbone and head of the training CLI,
every loss option, the full training augmentation, SWA, validation, the
epoch loop, model checkpoints in the JAX package's file layout and
resumable training states, data parallel), the eval path, the face
localizer, the host loader (HDF5 datasets, JPEG decoding on the card,
`FusedBatchLoader`), export to ONNX and its runtime, the face-model tools,
and the CLIs (`scripts/`), the paper-reproduction protocol and the
convergence band among them.
"""

__version__ = "0.1.0"
