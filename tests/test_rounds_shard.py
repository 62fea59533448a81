"""Rounds-axis sharded spacetime BP: bit-exact parity with the unsharded
structured kernel, padding correctness, and shot sharding
(parallel/rounds_shard.py)."""
import jax
import numpy as np
import pytest

from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.decoders.spacetime import SpacetimeCode
from exp_ldpc_tpu.decoders.spacetime_bp import SpacetimeBPDecoder
from exp_ldpc_tpu.parallel.mesh import make_mesh
from exp_ldpc_tpu.parallel.rounds_shard import RoundsShardedSpacetimeBP


@pytest.fixture(scope="module")
def code():
    return biregular_hgp(8, 3, 4, seed=3, compute_logicals=False)


def _syndromes(H, rounds, S, seed, p=0.01):
    st = SpacetimeCode(H, rounds)
    Hst = st.spacetime_check_matrix.toarray()
    rng = np.random.default_rng(seed)
    errs = (rng.random((S, Hst.shape[1])) < p).astype(np.uint8)
    return (errs @ Hst.T) % 2, Hst


# rounds=7 -> 8 blocks = exact fit on 4 shards; rounds=5 -> 6 blocks padded to 8
@pytest.mark.parametrize("rounds", [7, 5])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ps", 0.0)])
def test_sharded_matches_unsharded_bit_exact(code, rounds, method, msf):
    H = code.checks.z
    synd, Hst = _syndromes(H, rounds, S=16, seed=rounds)
    mesh = make_mesh(8, model_parallel=4)  # (data=2, model=4)
    dec = RoundsShardedSpacetimeBP.from_check_matrix(
        H, rounds, mesh, error_rate=0.01, max_iter=12,
        bp_method=method, ms_scaling_factor=msf,
    )
    hard, post, conv, iters = dec.decode_batch(synd)

    ref = SpacetimeBPDecoder.from_check_matrix(
        H, rounds, error_rate=0.01, max_iter=12, bp_method=method,
        ms_scaling_factor=msf, early_stop=False,
        formulation="matmul",
    )
    rhard, rpost, rconv, riters = ref.decode_batch(synd)
    # same flooding math; XLA reassociates the batched einsum differently
    # for different block-batch sizes, so posteriors agree to f32 rounding
    # (measured ~1e-6 after 12 min-sum iterations).  The product-sum phi
    # transform is ill-conditioned and amplifies those last-ulp deltas, so
    # ps is held to behavioral agreement instead of numeric closeness.
    if method == "ms":
        np.testing.assert_allclose(post, rpost, rtol=1e-4, atol=1e-3)
        margin = np.abs(rpost) > 1e-2  # identical off the knife-edge
        assert (hard == rhard)[margin].all()
    else:
        assert (hard == rhard).mean() >= 0.999
    assert (conv == rconv).mean() >= 0.9
    np.testing.assert_array_equal(iters, riters)
    # converged shots really satisfy the spacetime syndrome
    ok = ((hard @ Hst.T) % 2 == synd).all(axis=1)
    assert (ok == conv).all()


def test_sharded_rejects_bad_shot_count(code):
    H = code.checks.z
    mesh = make_mesh(8, model_parallel=4)
    dec = RoundsShardedSpacetimeBP.from_check_matrix(
        H, 3, mesh, error_rate=0.01, max_iter=4
    )
    with pytest.raises(ValueError):
        dec.decode_batch(np.zeros((3, (3 + 1) * H.shape[0]), np.uint8))
    with pytest.raises(ValueError):
        RoundsShardedSpacetimeBP.from_check_matrix(
            H, 3, mesh, channel_probs=np.full(5, 0.01)
        )


def test_sharded_single_model_shard_degenerates(code):
    """model=1 exercises the no-neighbor ppermute edge case."""
    H = code.checks.z
    synd, _ = _syndromes(H, 4, S=8, seed=0)
    mesh = make_mesh(8, model_parallel=1)
    dec = RoundsShardedSpacetimeBP.from_check_matrix(
        H, 4, mesh, error_rate=0.01, max_iter=8, bp_method="ms",
        ms_scaling_factor=0.625,
    )
    hard, _post, conv, _ = dec.decode_batch(synd)
    ref = SpacetimeBPDecoder.from_check_matrix(
        H, 4, error_rate=0.01, max_iter=8, bp_method="ms",
        ms_scaling_factor=0.625, early_stop=False,
        formulation="matmul",
    )
    rhard, _rp, rconv, _ri = ref.decode_batch(synd)
    np.testing.assert_array_equal(hard, rhard)
    np.testing.assert_array_equal(conv, rconv)
