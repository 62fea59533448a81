"""The Pallas-Triton fixed-iteration spacetime BP kernel
(decoders/spacetime_bp_triton.py) in interpret mode against the XLA
structured core, its size gate, and the pipeline's choice of it."""
import jax.numpy as jnp
import numpy as np
import pytest

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import priors_to_llr
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu.decoders.spacetime_bp import _stbp_core
from exp_ldpc_tpu.decoders.spacetime_bp_triton import fits_stbp_triton, stbp_triton_fixed
from exp_ldpc_tpu.decoders.tanner import TannerELL


@pytest.fixture(scope="module")
def small():
    H = biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
    return H, TannerELL.from_check_matrix(H.checks.z)


@pytest.mark.parametrize("S", [40, 23])  # neither a multiple of the block
@pytest.mark.parametrize("rounds", [0, 1, 3])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_kernel_matches_xla_core(small, method, msf, rounds, S):
    """Convergence flags and hard decisions equal the XLA core's; the
    posteriors differ only by f32 summation order (min-sum) or, on
    unconverged sum-product shots, by how far that order carries."""
    code, tanner = small
    H = code.checks.z
    r, n = H.shape
    Hst = SpacetimeCode(H, rounds).spacetime_check_matrix.toarray() % 2
    rng = np.random.default_rng(rounds * 7 + S)
    errs = (rng.random((S, Hst.shape[1])) < 0.02).astype(np.int64)
    synd = jnp.asarray(((errs @ Hst.T) % 2).astype(np.uint8).T)
    prior = np.concatenate([np.full((rounds + 1) * n, 0.01), np.full(rounds * r, 0.005)])
    pr = jnp.asarray(priors_to_llr(prior))
    h1, p1, c1, i1 = _stbp_core(tanner, rounds, pr, synd, method, 12,
                                jnp.float32(msf), False, "gather")
    h2, p2, c2, i2 = stbp_triton_fixed(tanner, rounds, pr, synd, method, 12, msf,
                                       interpret=True)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(i2), np.full(S, 12))
    if method == "ms":
        np.testing.assert_allclose(np.asarray(p2), np.asarray(p1), rtol=1e-5, atol=1e-4)
    ok = ((np.asarray(h2).T.astype(np.int64) @ Hst.T) % 2
          == np.asarray(synd).T).all(axis=1)
    np.testing.assert_array_equal(ok, np.asarray(c2))  # honest flags


def test_fits_gate():
    hgp225 = biregular_hgp(12, 3, 4, seed=0, compute_logicals=False).checks.z
    assert fits_stbp_triton(TannerELL.from_check_matrix(hgp225))
    big = biregular_hgp(40, 3, 4, seed=0, compute_logicals=False).checks.z
    assert not fits_stbp_triton(TannerELL.from_check_matrix(big))


def test_pipeline_picks_kernel_where_the_decision_says(small, monkeypatch):
    """The pipeline runs the kernel when the platform decision says
    "triton", the stage is fixed-iteration f32 and the code fits; the XLA
    core otherwise (nothing is run here: the CPU has no Triton)."""
    import exp_ldpc_tpu.parallel.pipeline as pmod
    from exp_ldpc_tpu.circuits.noise import depolarizing_noise

    code, _t = small
    kw = dict(code=code, rounds=2, noise_model=depolarizing_noise(0.01, 0.01),
              data_prior=0.007, meas_prior=0.007, shots_per_device=8, max_iter=4)
    assert pmod.StorageDecodePipeline(**kw)._kernel is False
    monkeypatch.setattr(pmod, "bp_backend", lambda devices=None: "triton")
    assert pmod.StorageDecodePipeline(**kw)._kernel is True
    assert pmod.StorageDecodePipeline(early_stop=True, **kw)._kernel is False
    assert pmod.StorageDecodePipeline(msg_dtype="bfloat16", **kw)._kernel is False
