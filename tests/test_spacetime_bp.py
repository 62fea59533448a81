"""Structured spacetime BP (decoders/spacetime_bp.py) vs generic BP on the
stacked spacetime matrix: same flooding math, factored per-round routing."""
import numpy as np
import pytest

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.bp import BPDecoder
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder


@pytest.fixture(scope="module")
def small_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=False)


@pytest.mark.parametrize("rounds", [0, 1, 3])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ps", 0.0), ("ms", 0.0)])
def test_structured_matches_generic(small_code, rounds, method, msf):
    """Hard decisions, convergence flags, and iteration counts must match the
    generic decoder exactly (the message math is identical; only matmul
    accumulation order differs, which cannot flip mins or signs for ms and
    leaves hard decisions equal in practice for ps)."""
    H = small_code.checks.z
    r, n = H.shape
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix
    rng = np.random.default_rng(rounds)
    prior = np.concatenate([np.full((rounds + 1) * n, 0.01), np.full(rounds * r, 0.005)])
    S = 48
    errs = (rng.random((S, Hst.shape[1])) < 0.02).astype(np.uint8)
    synd = (errs @ Hst.T.toarray()) % 2

    gen = BPDecoder.from_check_matrix(
        Hst, channel_probs=prior, max_iter=24, bp_method=method, ms_scaling_factor=msf
    )
    stb = SpacetimeBPDecoder.from_check_matrix(
        H, rounds, channel_probs=prior, max_iter=24, bp_method=method, ms_scaling_factor=msf
    )
    h1, p1, c1, i1 = gen.decode_batch(synd)
    h2, p2, c2, i2 = stb.decode_batch(synd)
    assert (c1 == c2).all()
    assert (h1 == h2).all()
    assert (i1 == i2).all()
    # posteriors agree up to matmul reassociation
    assert np.max(np.abs(p1 - p2) / (1 + np.abs(p1))) < 0.1


@pytest.mark.parametrize("formulation", ["matmul", "gather"])
def test_structured_formulations_agree(small_code, formulation):
    """Both variable-update routing paths of the structured core produce the
    same decodes."""
    H = small_code.checks.z
    r, n = H.shape
    rounds = 2
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix
    rng = np.random.default_rng(0)
    S = 32
    errs = (rng.random((S, Hst.shape[1])) < 0.02).astype(np.uint8)
    synd = (errs @ Hst.T.toarray()) % 2
    ref = SpacetimeBPDecoder.from_check_matrix(
        H, rounds, error_rate=0.01, max_iter=16, bp_method="ms", ms_scaling_factor=0.625
    )
    alt = SpacetimeBPDecoder.from_check_matrix(
        H, rounds, error_rate=0.01, max_iter=16, bp_method="ms", ms_scaling_factor=0.625,
        formulation=formulation,
    )
    h1, _, c1, _ = ref.decode_batch(synd)
    h2, _, c2, _ = alt.decode_batch(synd)
    assert (h1 == h2).all() and (c1 == c2).all()


def test_structured_converged_shots_satisfy_syndrome(small_code):
    H = small_code.checks.z
    r, n = H.shape
    rounds = 2
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix.toarray()
    rng = np.random.default_rng(3)
    S = 64
    errs = (rng.random((S, Hst.shape[1])) < 0.03).astype(np.uint8)
    synd = (errs @ Hst.T) % 2
    dec = SpacetimeBPDecoder.from_check_matrix(
        H, rounds, error_rate=0.02, max_iter=40, bp_method="ms", ms_scaling_factor=0.625
    )
    hard, _post, conv, _iters = dec.decode_batch(synd)
    assert conv.sum() > 0
    ok = ((hard @ Hst.T) % 2 == synd).all(axis=1)
    assert ok[conv].all()


def test_bad_options_raise(small_code):
    H = small_code.checks.z
    with pytest.raises(ValueError):
        SpacetimeBPDecoder.from_check_matrix(H, 2, max_iter=8)  # no prior
    with pytest.raises(ValueError):
        SpacetimeBPDecoder.from_check_matrix(H, 2, error_rate=0.01, bp_method="bogus")
    with pytest.raises(ValueError):
        SpacetimeBPDecoder.from_check_matrix(
            H, 2, channel_probs=np.full(3, 0.1)  # wrong length
        )


def test_bf16_messages_statistically_equivalent(small_code):
    """msg_dtype="bfloat16" halves message bandwidth; decodes must stay
    statistically interchangeable with f32 (not bit-exact)."""
    H = small_code.checks.z
    r, n = H.shape
    rounds = 2
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix.toarray()
    rng = np.random.default_rng(11)
    S = 256
    errs = (rng.random((S, Hst.shape[1])) < 0.02).astype(np.uint8)
    synd = (errs @ Hst.T) % 2
    kw = dict(error_rate=0.015, max_iter=32, bp_method="ms", ms_scaling_factor=0.625)
    f32 = SpacetimeBPDecoder.from_check_matrix(H, rounds, **kw)
    b16 = SpacetimeBPDecoder.from_check_matrix(H, rounds, msg_dtype="bfloat16", **kw)
    h1, _, c1, _ = f32.decode_batch(synd)
    h2, _, c2, _ = b16.decode_batch(synd)
    # converged bf16 shots satisfy the syndrome exactly
    ok = ((h2 @ Hst.T) % 2 == synd).all(axis=1)
    assert ok[c2].all()
    # convergence and hard decisions agree on nearly every shot
    assert (c1 == c2).mean() > 0.95
    assert (h1 == h2).all(axis=1).mean() > 0.9


@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ps", 0.0), ("ms", 0.0)])
def test_pallas_kernel_matches_core(small_code, method, msf):
    """The Pallas-Triton spacetime kernel (interpret mode on CPU) reproduces
    the XLA structured core's hard decisions and convergence."""
    import jax.numpy as jnp

    from exp_ldpc_tpu.decoders.bp import priors_to_llr
    from exp_ldpc_tpu.decoders.spacetime_bp import _stbp_core
    from exp_ldpc_tpu.decoders.spacetime_bp_triton import stbp_triton_fixed
    from exp_ldpc_tpu.decoders.tanner import TannerELL

    H = small_code.checks.z
    r, n = H.shape
    rounds = 2
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix
    tanner = TannerELL.from_check_matrix(H)
    prior = np.concatenate([np.full((rounds + 1) * n, 0.01), np.full(rounds * r, 0.005)])
    prior_llr = jnp.asarray(priors_to_llr(prior))
    rng = np.random.default_rng(5)
    S = 40  # not a multiple of the 16-shot block: exercises padding
    errs = (rng.random((S, Hst.shape[1])) < 0.02).astype(np.uint8)
    synd = jnp.asarray(((errs @ Hst.T.toarray()) % 2).astype(np.uint8).T)
    h1, _p1, c1, _ = _stbp_core(tanner, rounds, prior_llr, synd, method, 12,
                                jnp.float32(msf), False, "matmul")
    h2, _p2, c2, _ = stbp_triton_fixed(tanner, rounds, prior_llr, synd, method, 12,
                                       msf, interpret=True)
    assert (np.asarray(h1) == np.asarray(h2)).all()
    assert (np.asarray(c1) == np.asarray(c2)).all()


def test_pipeline_backend_resolution(small_code):
    """The pipeline asks the one platform decision (select.bp_backend): it
    builds on the CPU, and a platform with no backend raises at
    construction instead of running unchecked formulations."""
    from exp_ldpc_tpu.circuits.noise import depolarizing_noise
    from exp_ldpc_tpu.decoders import select
    from exp_ldpc_tpu.parallel.pipeline import StorageDecodePipeline

    import exp_ldpc_tpu.codes.hgp as hgp
    code = hgp.biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
    kw = dict(code=code, rounds=2, noise_model=depolarizing_noise(0.01, 0.01),
              data_prior=0.007, meas_prior=0.007, shots_per_device=8, max_iter=4)
    pipe = StorageDecodePipeline(**kw)
    assert select.bp_backend() == "xla"  # CPU backend in tests
    assert pipe._kernel is False  # the XLA core on the CPU
    f, s, _u = pipe.run(__import__("jax").random.PRNGKey(0))
    assert s == 8 and 0 <= f <= 8

    class _Dev:
        platform = "metal"

    with pytest.raises(ValueError, match="no BP backend"):
        select.bp_backend([_Dev()])
    with pytest.raises(TypeError):
        StorageDecodePipeline(bp_backend="pallas", **kw)  # option removed


def test_decoder_fixed_iteration_and_backend_options(small_code):
    H = small_code.checks.z
    r, n = H.shape
    rounds = 2
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix.toarray()
    rng = np.random.default_rng(9)
    S = 32
    errs = (rng.random((S, Hst.shape[1])) < 0.02).astype(np.uint8)
    synd = (errs @ Hst.T) % 2
    dec = SpacetimeBPDecoder.from_check_matrix(
        H, rounds, error_rate=0.015, max_iter=24, bp_method="ms",
        ms_scaling_factor=0.625, early_stop=False)
    hard, _post, conv, iters = dec.decode_batch(synd)
    assert (iters == 24).all()  # fixed-iteration mode
    ok = ((hard @ Hst.T) % 2 == synd).all(axis=1)
    assert (ok == conv).all()
    # the factory builds the same decoder through the platform decision
    from exp_ldpc_tpu.decoders.select import make_spacetime_bp_decoder

    dec2 = make_spacetime_bp_decoder(
        H, rounds, error_rate=0.015, max_iter=24, bp_method="ms",
        ms_scaling_factor=0.625, early_stop=False)
    hard2, _p2, conv2, _i2 = dec2.decode_batch(synd)
    assert (hard2 == hard).all() and (conv2 == conv).all()
