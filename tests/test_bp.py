"""BP decoder tests: JAX-vs-numpy parity, exact marginals on trees, syndrome validity."""
import numpy as np
import pytest

from exp_ldpc_tpu.decoders.bp import BPDecoder
from exp_ldpc_tpu.decoders.bp_numpy import NumpyBPDecoder


def random_ldpc(rng, r, n, row_w=4):
    H = np.zeros((r, n), dtype=np.uint8)
    for i in range(r):
        H[i, rng.choice(n, size=row_w, replace=False)] = 1
    # avoid zero columns
    for j in range(n):
        if not H[:, j].any():
            H[rng.integers(r), j] = 1
    return H


@pytest.mark.parametrize("method", ["ps", "ms"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jax_matches_numpy(method, seed):
    rng = np.random.default_rng(seed)
    H = random_ldpc(rng, 15, 30)
    probs = rng.uniform(0.005, 0.05, size=30)
    synds = rng.integers(0, 2, size=(8, 15)).astype(np.uint8)
    kw = dict(channel_probs=probs, bp_method=method, max_iter=30, ms_scaling_factor=0.0)
    # pin the gather formulation: it shares the numpy oracle's f32 summation
    # order exactly (the matmul formulation tree-sums; see test below)
    jd = BPDecoder.from_check_matrix(H, formulation="gather", **kw)
    nd = NumpyBPDecoder.from_check_matrix(H, **kw)
    hj, pj, cj, ij = jd.decode_batch(synds)
    hn, pn, cn, in_ = nd.decode_batch(synds)
    assert np.array_equal(np.asarray(cj), cn)
    assert np.array_equal(np.asarray(ij), in_)
    assert np.array_equal(np.asarray(hj), hn)
    # f32 accumulation order differs between XLA fusion and numpy; tolerance
    # covers ~30 iterations of drift on unconverged shots
    assert np.allclose(np.asarray(pj), pn, rtol=1e-2, atol=5e-3)


@pytest.mark.parametrize("method", ["ps", "ms"])
def test_matmul_formulation_agrees_with_gather(method):
    """The one-hot matmul message routing must agree with the gather routing on
    every converged shot (both satisfy the syndrome exactly) and on the vast
    majority of hard decisions overall (f32 ordering may differ on
    non-converged shots)."""
    rng = np.random.default_rng(3)
    H = random_ldpc(rng, 24, 48)
    errs = (rng.random((64, 48)) < 0.03).astype(np.uint8)
    synds = (errs @ H.T) % 2
    kw = dict(error_rate=0.03, bp_method=method, max_iter=40)
    dg = BPDecoder.from_check_matrix(H, formulation="gather", **kw)
    dm = BPDecoder.from_check_matrix(H, formulation="matmul", **kw)
    hg, _pg, cg, _ = dg.decode_batch(synds)
    hm, _pm, cm, _ = dm.decode_batch(synds)
    hg, hm = np.asarray(hg), np.asarray(hm)
    cg, cm = np.asarray(cg), np.asarray(cm)
    for i in range(synds.shape[0]):
        if cm[i]:
            assert np.array_equal((hm[i] @ H.T) % 2, synds[i])
    # convergence behaviour should be near-identical
    assert (cg == cm).mean() >= 0.95
    assert (hg == hm).mean() >= 0.99


def test_converged_solutions_satisfy_syndrome():
    rng = np.random.default_rng(7)
    H = random_ldpc(rng, 20, 50)
    # syndromes of actual sparse errors (guaranteed decodable-ish)
    errs = (rng.random((16, 50)) < 0.03).astype(np.uint8)
    synds = (errs @ H.T) % 2
    dec = BPDecoder.from_check_matrix(H, error_rate=0.03, bp_method="ps", max_iter=60)
    hard, _post, conv, _ = dec.decode_batch(synds)
    hard = np.asarray(hard)
    for i in np.nonzero(np.asarray(conv))[0]:
        assert np.array_equal((hard[i] @ H.T) % 2, synds[i])


def test_sum_product_exact_on_tree():
    """On a cycle-free Tanner graph, sum-product posteriors equal the exact
    conditional marginals."""
    H = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1]], dtype=np.uint8)  # path: tree
    p = 0.08
    # early_stop=False: run to fixed point so posteriors reach the exact marginals
    dec = BPDecoder.from_check_matrix(H, error_rate=p, bp_method="ps", max_iter=20, early_stop=False)
    synds = np.array([[0, 1, 0], [1, 1, 0], [1, 0, 1]], dtype=np.uint8)
    _hard, post, conv, _ = dec.decode_batch(synds)
    post = np.asarray(post)

    def exact_marginals(s):
        margs = np.zeros(4)
        Z = 0.0
        for e in range(16):
            x = np.array([(e >> i) & 1 for i in range(4)])
            if np.all((H @ x) % 2 == s):
                w = (p ** x.sum()) * ((1 - p) ** (4 - x.sum()))
                Z += w
                margs += w * x
        return margs / Z

    for i, s in enumerate(synds):
        exact = exact_marginals(s)
        bp_prob = 1.0 / (1.0 + np.exp(post[i].astype(np.float64)))
        assert np.allclose(bp_prob, exact, atol=1e-4), (bp_prob, exact)


def test_per_column_priors_break_ties():
    # single check on two bits, syndrome 1: the higher-prior column is chosen
    H = np.array([[1, 1]], dtype=np.uint8)
    dec = BPDecoder.from_check_matrix(H, channel_probs=np.array([0.01, 0.2]), max_iter=10)
    hard, _p, conv, _ = dec.decode_batch(np.array([[1]], dtype=np.uint8))
    assert np.asarray(conv)[0]
    assert np.asarray(hard)[0].tolist() == [0, 1]


def test_min_sum_fixed_scaling():
    rng = np.random.default_rng(11)
    H = random_ldpc(rng, 12, 24)
    errs = (rng.random((8, 24)) < 0.04).astype(np.uint8)
    synds = (errs @ H.T) % 2
    dec = BPDecoder.from_check_matrix(
        H, error_rate=0.04, bp_method="ms", ms_scaling_factor=0.625, max_iter=40
    )
    hard, _p, conv, _ = dec.decode_batch(synds)
    hard = np.asarray(hard)
    for i in np.nonzero(np.asarray(conv))[0]:
        assert np.array_equal((hard[i] @ H.T) % 2, synds[i])
