"""Fit the diagonal GMM prior over the 50 shape parameters (counterpart of the
JAX package's `scripts/fit_shapeparams_gmm.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.fit_shapeparams_gmm a.h5 [b.h5 ...] \\
        [--components K] [--out prior.npz|prior.h5]

Fits a sklearn `GaussianMixture` (diagonal covariance, `random_state` 1234,
`reg_covar` 1e-4) over the `shapeparams` field of the pose files. `--out`
ending in `.npz` is written in the port's asset layout, which
`GaussianMixture.from_npz` and `ShapePlausibilityLoss` read (the default is
the port's `facemodel/assets/shapeparams_gmm.npz`); any other name gets the
JAX package's h5 layout. Host only: it needs sklearn and h5py, imported
inside `main`, and no device.
"""

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from neuralnet_tracker_traincode_torch.models.components import SHAPEPARAMS_GMM_NPZ

    parser = argparse.ArgumentParser(description="Fit the diagonal GMM prior over the shape parameters")
    parser.add_argument("sources", nargs="+", help="pose HDF5 files with a shapeparams field")
    parser.add_argument("--components", type=int, default=None,
                        help="Number of mixture components (default: min(10, N // 8))")
    parser.add_argument("--out", default=SHAPEPARAMS_GMM_NPZ, help=".npz: the port's layout; else h5")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import h5py
    import sklearn.mixture

    from neuralnet_tracker_traincode_torch.models.components import GaussianMixture

    params = []
    for src in args.sources:
        with h5py.File(src, "r") as f:
            params.append(f["shapeparams"][...].astype(np.float64))
    params = np.concatenate(params, axis=0)
    n_components = args.components or max(1, min(10, len(params) // 8))
    print(f"Fitting {n_components}-component diag GMM over {params.shape} params")
    gmm = sklearn.mixture.GaussianMixture(
        n_components=n_components, covariance_type="diag", random_state=1234, reg_covar=1e-4
    )
    gmm.fit(params)
    prior = GaussianMixture.from_sklearn(gmm)
    if args.out.endswith(".npz"):
        prior.save_to_npz(args.out)
    else:
        with h5py.File(args.out, "w") as f:
            prior.save_to_hdf5(f, None)
    print(f"Wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
