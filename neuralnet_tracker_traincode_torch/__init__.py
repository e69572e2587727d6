"""PyTorch/CUDA port of the NeuralNet-tracker training code.

The package mirrors `neuralnet_tracker_traincode_tpu` module for module, in
PyTorch idiom (`nn.Module`s, explicit `device`, explicit `torch.Generator`s).
It imports nothing of the JAX package: the JAX package is the reference the
port is tested against (`tests/test_torch_*.py`).

The augmentation kernels that were Pallas TPU kernels are hand-written CUDA
kernels for Hopper (`kernels/csrc/`), built at first use. Entry points run on
the CUDA device unless the caller passes `device="cpu"`; on the CPU the kernel
wrappers take their plain PyTorch versions.

Ported so far: the pose-estimator training run (MobileNetV1 with point head,
NLL heads and the quaternion or 6D rotation head, every loss option of the
training CLI, the full training augmentation, SWA, validation, the epoch loop,
model checkpoints in the JAX package's file layout and resumable training
states) and the eval path (the Predictor's crop, f32 forward and
backtransform, the metrics, the rotation alignments and the evaluation
table). What waits is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
