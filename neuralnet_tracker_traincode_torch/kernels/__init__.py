"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

K1 `warp.warp_roi_rotate`, K2 `equalize.equalize`, K3 `noise.add_gaussian_noise`
(and `noise.add_gaussian_noise_from_bits`); the JPEG decode's K5
`jpeg_huffman.huffman_decode` and K4 `jpeg.idct_pack`. A wrapper launches its kernel for
a CUDA tensor and takes its plain version only for a CPU tensor. Sources are
in `csrc/`; `ext` builds them at first use and counts launches.
"""
