"""The gather branch of the structured spacetime core (``_stbp_core`` with
``formulation="gather"``, the routing large base codes take) against
generic BP on the stacked spacetime matrix, and its wiring through BP+OSD
and the fused pipeline at HGP-225 (1.3 MiB of one-hot routing operands)."""
import numpy as np
import pytest

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import BPDecoder
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder


@pytest.fixture(scope="module")
def hgp225():
    return biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)


def _setup(H, rounds, p, S, seed, meas_scale=1.0):
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix.tocsr()
    dense = Hst.toarray().astype(np.int64) % 2
    rng = np.random.default_rng(seed)
    err = (rng.random((S, dense.shape[1])) < p).astype(np.int64)
    synd = ((err @ dense.T) % 2).astype(np.uint8)
    r, n = H.shape
    prior = np.concatenate([
        np.full((rounds + 1) * n, p), np.full(rounds * r, p * meas_scale)])
    return Hst, dense, synd, prior


@pytest.mark.parametrize("rounds", [0, 1, 3])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
def test_gather_matches_generic_on_stacked_matrix(hgp225, rounds, method, msf):
    """Same flooding math in both: convergence flags equal exactly, hard
    decisions equal on every shot both converged on and on all but a
    knife-edge few elsewhere (the factored gather sums each variable's
    messages in another order than the stacked-matrix gather)."""
    H = hgp225.checks.z
    Hst, dense, synd, prior = _setup(H, rounds, 0.01, 40, rounds)
    kw = dict(channel_probs=prior, max_iter=12, bp_method=method,
              ms_scaling_factor=msf, early_stop=False)
    h_g, _p, c_g, i_g = SpacetimeBPDecoder.from_check_matrix(
        H, rounds, formulation="gather", **kw).decode_batch(synd)
    h_r, _pr, c_r, _ir = map(np.asarray, BPDecoder.from_check_matrix(
        Hst, formulation="gather", **kw).decode_batch(synd))
    np.testing.assert_array_equal(c_g, c_r)
    np.testing.assert_array_equal(h_g[c_g], h_r[c_g])
    assert (h_g == h_r).all(axis=1).mean() >= 0.95
    assert np.asarray(i_g).tolist() == [12] * 40
    ok = ((h_g.astype(np.int64) @ dense.T) % 2 == synd).all(axis=1)
    np.testing.assert_array_equal(ok, c_g)  # honest convergence flags


def test_gather_heterogeneous_priors(hgp225):
    """Per-column priors (measurement != data) flow through the factored
    layout; converged decisions satisfy their spacetime syndromes."""
    H = hgp225.checks.z
    _Hst, dense, synd, prior = _setup(H, 4, 0.01, 24, 9, meas_scale=0.25)
    h, _p, c, _i = SpacetimeBPDecoder.from_check_matrix(
        H, 4, channel_probs=prior, max_iter=16, bp_method="ms",
        ms_scaling_factor=0.625, early_stop=False,
        formulation="gather").decode_batch(synd)
    ok = ((h.astype(np.int64) @ dense.T) % 2 == synd).all(axis=1)
    np.testing.assert_array_equal(ok, c)
    assert c.sum() >= 12


def test_gather_early_stop_freezes_per_shot(hgp225):
    """Early stop freezes each shot at its first convergence (ldpc
    semantics), matching the generic decoder's iteration counts."""
    H = hgp225.checks.z
    Hst, dense, synd, _prior = _setup(H, 3, 0.002, 32, 5)
    kw = dict(error_rate=0.002, max_iter=60, bp_method="ms",
              ms_scaling_factor=0.625)
    h, _p, conv, iters = SpacetimeBPDecoder.from_check_matrix(
        H, 3, formulation="gather", **kw).decode_batch(synd)
    _h, _pr, c_r, i_r = map(np.asarray, BPDecoder.from_check_matrix(
        Hst, formulation="gather", **kw).decode_batch(synd))
    assert conv.all()
    np.testing.assert_array_equal(iters, i_r)
    assert len(set(np.asarray(iters).tolist())) > 1  # per shot, not global
    ok = ((h.astype(np.int64) @ dense.T) % 2 == synd).all(axis=1)
    assert ok.all()


def test_gather_in_bposd(hgp225):
    """Drop-in as the BP stage of BPOSDDecoder on the spacetime matrix:
    every output satisfies its syndrome (OSD covers the BP failures)."""
    from exp_ldpc_tpu.decoders.bposd import BPOSDDecoder

    H = hgp225.checks.z
    Hst, dense, synd, _prior = _setup(H, 2, 0.02, 24, 11)
    bp = SpacetimeBPDecoder.from_check_matrix(
        H, 2, error_rate=0.02, max_iter=8, bp_method="ms",
        ms_scaling_factor=0.625, formulation="gather")
    out = BPOSDDecoder(bp=bp, H=Hst, osd_method="osd0", osd_order=0).decode_batch(synd)
    np.testing.assert_array_equal((out.astype(np.int64) @ dense.T) % 2, synd)


@pytest.mark.parametrize("rounds", [1, 3])
def test_pipeline_wiring_matches_host_decode(hgp225, rounds):
    """The fused pipeline at HGP-225 (above 1 MiB of routing operands)
    decodes CPU-oracle records to the same failure and unconverged counts
    as the host path: history -> differenced syndromes -> gather-branch
    spacetime BP -> final-round correction -> logical check."""
    import jax

    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline
    from exp_ldpc_tpu.sampler.reference import FrameSampler

    p, S, seed = 3e-3, 96, 4
    pipe = StorageDecodePipeline(
        code=hgp225, rounds=rounds, noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=S,
        max_iter=16, bp_method="ms", ms_scaling_factor=0.625)
    f_dev, s_dev, u_dev = pipe.run_host_sampled(seed)

    rec = FrameSampler(pipe.storage_sim.circuit, seed=seed).sample(S).astype(np.int64)
    r, xc, n = pipe.z_count, pipe.x_count, pipe.num_data
    mpr = xc + r
    hist = np.stack([rec[:, k * mpr + xc: k * mpr + xc + r] for k in range(rounds)], axis=1)
    readout = rec[:, mpr * rounds: mpr * rounds + n]
    synd = pipe.spacetime.syndrome_from_history_batch(hist, readout)
    dec = SpacetimeBPDecoder(
        tanner=pipe.tanner, num_rounds=rounds, prior_llr=pipe.prior_llr,
        max_iter=16, method="ms", ms_scaling_factor=0.625,
        formulation="gather", early_stop=False)
    hard, _p, conv, _i = dec.decode_batch(synd)
    corr = pipe.spacetime.final_correction(hard.astype(np.int64))
    flips = ((readout + corr) % 2) @ np.asarray(hgp225.logicals.z, np.int64).T % 2
    assert s_dev == S
    assert u_dev == int((~conv).sum())
    assert f_dev == int(flips.any(axis=1).sum())
    assert jax.devices()[0].platform == "cpu"
