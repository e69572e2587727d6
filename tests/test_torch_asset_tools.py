"""The port's host-only asset tools against the JAX package's scripts, on
the CPU: the GMM shape prior (`fit_shapeparams_gmm`), the fallback keypoint
model (`make_bfm_fallback`) and the BFM conversion (`convert_bfm`).

Tolerances: the GMM arrays are equal (the same sklearn fit, seed 1234, on
the same f64 data); the prior's log-likelihood through the port's npz is
within 1e-5 relative of the JAX one (the npz holds weights and means in f4,
and both packages compute in f32); the fallback model within 1e-6 (the same
f64 numpy); the converted keypoint model equal. Every run writes into a
temporary directory: the tools' default `--out` is a packaged asset.
"""

import sys
from os.path import dirname, join, realpath

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.facemodel import bfm as JB
from neuralnet_tracker_traincode_tpu.models.components import GaussianMixture as JGMM
from neuralnet_tracker_traincode_torch.facemodel import bfm as TB
from neuralnet_tracker_traincode_torch.models.components import SHAPEPARAMS_GMM_NPZ, GaussianMixture
from neuralnet_tracker_traincode_torch.scripts import convert_bfm, fit_shapeparams_gmm, make_bfm_fallback
from tests.test_pipelines import write_pose_h5
from torch_port_helpers import two_intra_op_threads, write_synthetic_bfm_pickle  # noqa: F401

sys.path.insert(0, join(dirname(realpath(__file__)), "..", "scripts"))
import convert_bfm as j_convert_bfm  # noqa: E402
import fit_shapeparams_gmm as j_fit_shapeparams_gmm  # noqa: E402
import make_bfm_fallback as j_make_bfm_fallback  # noqa: E402


@pytest.fixture
def sklearn():
    return pytest.importorskip("sklearn")


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("gmm") / "shapes.h5")
    write_pose_h5(src, 256, seed=17)
    return src


@pytest.fixture
def fresh_subset_cache():
    TB._load_subset_arrays.cache_clear()
    yield
    TB._load_subset_arrays.cache_clear()


def jax_prior(monkeypatch, src, out, *flags):
    monkeypatch.setattr(sys, "argv", ["fit_shapeparams_gmm.py", src, "--out", out, *flags])
    j_fit_shapeparams_gmm.main()
    return out


@pytest.mark.parametrize("components", [None, 2])
def test_the_prior_file_is_the_jax_one(sklearn, shapes, tmp_path, monkeypatch, components):
    flags = [] if components is None else ["--components", str(components)]
    ref = jax_prior(monkeypatch, shapes, str(tmp_path / "jax.h5"), *flags)
    ours = str(tmp_path / "torch.h5")
    assert fit_shapeparams_gmm.main([shapes, "--out", ours, *flags]) == 0
    with h5py.File(ours, "r") as a, h5py.File(ref, "r") as b:
        assert sorted(a.keys()) == sorted(b.keys()) == ["cov", "means", "weights"]
        assert a.attrs["covariance_type"] == b.attrs["covariance_type"] == "diag"
        for k in a.keys():
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k][...], b[k][...], err_msg=k)
        assert len(a["weights"]) == (components or 10)


def test_the_prior_npz_loads_with_the_jax_likelihood(sklearn, shapes, tmp_path, monkeypatch):
    ref = JGMM.from_hdf5(jax_prior(monkeypatch, shapes, str(tmp_path / "jax.h5"), "--components", "2"))
    npz = str(tmp_path / "prior.npz")
    assert fit_shapeparams_gmm.main([shapes, "--out", npz, "--components", "2"]) == 0
    with np.load(npz) as f:
        assert sorted(f.files) == ["cov", "covariance_type", "means", "weights"]
        assert (f["weights"].dtype, f["means"].dtype, f["cov"].dtype) == (np.float32, np.float32, np.float64)
        assert str(f["covariance_type"]) == "diag"
    ours = GaussianMixture.from_npz(npz)
    assert ours.n_components == 2
    with h5py.File(shapes, "r") as f:
        x = f["shapeparams"][:8].astype(np.float32)
    far = np.full((8, 50), 50.0, np.float32)
    for xs in (x, far):
        want = np.asarray(ref(jnp.asarray(xs)))
        np.testing.assert_allclose(ours(torch.from_numpy(xs)).numpy(), want, rtol=1e-5)
    assert (ours(torch.from_numpy(x)) > ours(torch.from_numpy(far))).all()


def test_the_gmm_writers_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    gmm = GaussianMixture(rng.dirichlet(np.ones(3)), rng.randn(3, 50), rng.uniform(0.5, 2.0, (3, 50)))
    with h5py.File(tmp_path / "g.h5", "w") as f:
        gmm.save_to_hdf5(f, "prior")
    with h5py.File(tmp_path / "g.h5", "r") as f:
        back = GaussianMixture.from_hdf5(f["prior"])
        ref = JGMM.from_hdf5(f["prior"])
    x = rng.randn(5, 50).astype(np.float32)
    np.testing.assert_array_equal(back(torch.from_numpy(x)).numpy(), gmm(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(back(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))), rtol=1e-6)
    from_npz = GaussianMixture.from_npz(gmm.save_to_npz(str(tmp_path / "g.npz")))
    np.testing.assert_allclose(from_npz(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))), rtol=1e-5)


def test_from_sklearn_is_the_jax_one(sklearn, shapes):
    import sklearn.mixture

    with h5py.File(shapes, "r") as f:
        params = f["shapeparams"][...].astype(np.float64)
    sk = sklearn.mixture.GaussianMixture(n_components=3, covariance_type="diag", random_state=1234).fit(params)
    ours, ref = GaussianMixture.from_sklearn(sk), JGMM.from_sklearn(sk)
    for k in ("weights", "means", "cov"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))


def test_the_fallback_fit_is_the_jax_one(tmp_path):
    src = str(tmp_path / "labels.h5")
    write_pose_h5(src, 40, seed=5)  # N = 40 < 1 + K = 51: the minimal-norm solution
    ours, ref = make_bfm_fallback.fit_fallback(src), j_make_bfm_fallback.fit_fallback(src)
    for a, b, shape in zip(ours, ref, [(68, 3), (40, 68, 3), (10, 68, 3)]):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_the_fallback_cli_writes_a_fallback_model(tmp_path, monkeypatch, fresh_subset_cache):
    src = str(tmp_path / "labels.h5")
    write_pose_h5(src, 40, seed=5)
    out, jout = str(tmp_path / "fallback.npz"), str(tmp_path / "jax_fallback.npz")
    assert make_bfm_fallback.main(["--source", src, "--out", out]) == 0
    monkeypatch.setattr(sys, "argv", ["make_bfm_fallback.py", "--source", src, "--out", jout])
    j_make_bfm_fallback.main()
    with np.load(out) as a, np.load(jout) as b:
        assert sorted(a.files) == sorted(b.files)
        assert str(a["source"]) == str(b["source"]) == "fitted_fallback"
        for k in ("keypts", "w_shp", "w_exp"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    monkeypatch.setattr(TB, "SUBSET_ARTIFACT", out)
    model = TB.BFMModel()
    assert model.source == "fitted_fallback" and not model.is_authentic


def test_convert_bfm_is_the_jax_one(tmp_path, monkeypatch, fresh_subset_cache):
    pkl = write_synthetic_bfm_pickle(tmp_path / "bfm_noneck_v3.pkl")
    out, jout = str(tmp_path / "subset.npz"), str(tmp_path / "jax_subset.npz")
    assert convert_bfm.main([pkl, "--out", out]) == 0
    monkeypatch.setattr(sys, "argv", ["convert_bfm.py", pkl, "--out", jout])
    j_convert_bfm.main()
    with np.load(out) as a, np.load(jout) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    monkeypatch.setattr(TB, "SUBSET_ARTIFACT", out)
    monkeypatch.setattr(JB, "SUBSET_ARTIFACT", jout)
    JB._load_subset_arrays.cache_clear()
    try:
        ours, ref = TB.BFMModel(), JB.BFMModel()
        assert ours.is_authentic and ref.is_authentic and ours.source == ref.source == "bfm_noneck_v3.pkl"
        np.testing.assert_array_equal(ours.keypts, ref.keypts)
        np.testing.assert_array_equal(ours.scaled_bases, ref.scaled_bases)
    finally:
        JB._load_subset_arrays.cache_clear()


def test_the_packaged_model_is_the_fallback(fresh_subset_cache):
    ours, ref = TB.BFMModel(), JB.BFMModel()
    assert ours.source == ref.source == "fitted_fallback"
    assert ours.is_authentic == ref.is_authentic is False


def test_the_default_outputs_are_the_packaged_assets():
    """Which is why every test and `chip_smoke.py` pass `--out`."""
    assert fit_shapeparams_gmm.build_parser().parse_args(["a.h5"]).out == SHAPEPARAMS_GMM_NPZ
    assert make_bfm_fallback.build_parser().parse_args(["--source", "a.h5"]).out == TB.SUBSET_ARTIFACT
    assert convert_bfm.build_parser().parse_args(["a.pkl"]).out == TB.SUBSET_ARTIFACT
