"""Training augmentation: label affines, the crop warp (K1), intensity (K2)
and noise (K3) stages, and the pipeline that chains them."""
