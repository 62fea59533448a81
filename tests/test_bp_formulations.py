"""Oracle parity of the BP formulations ``make_bp_decoder`` picks.

Each code family is decoded by the decoder the selection module builds for
it (one-hot matmul ``BPDecoder`` for small codes, the quasi-cyclic roll
``QCBPDecoder`` for large block-circulant ones) and by the plain numpy
oracle (``decoders/bp_numpy.py``) on the same syndromes, for min-sum with a
fixed and the adaptive scaling, sum-product, and both per-shot early stop
and fixed-iteration flooding.
"""
import numpy as np
import pytest

from exp_ldpc_tpu.codes.bivariate_bicycle import bivariate_bicycle_code
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.codes.qc_lifted import qc_lifted_product_code
from exp_ldpc_tpu.decoders.bp import BPDecoder
from exp_ldpc_tpu.decoders.bp_numpy import NumpyBPDecoder
from exp_ldpc_tpu.decoders.qc_bp import QCBPDecoder
from exp_ldpc_tpu.decoders.select import make_bp_decoder, qc_kwargs_for_code


def random_ldpc(rng, r, n, row_w=6):
    H = np.zeros((r, n), dtype=np.uint8)
    for i in range(r):
        H[i, rng.choice(n, size=row_w, replace=False)] = 1
    for j in range(n):
        if not H[:, j].any():
            H[rng.integers(r), j] = 1
    return H


def _family(name):
    if name == "random_ldpc":
        return random_ldpc(np.random.default_rng(7), 60, 120), {}, BPDecoder
    if name == "hgp":
        code = biregular_hgp(6, 2, 3, seed=1, compute_logicals=False)
        return code.checks.z, {}, BPDecoder
    if name == "qc_lp":  # [[1054,140]]: past the roll kernel's operand threshold
        code = qc_lifted_product_code(
            [[1, 2, 4, 8, 16], [5, 10, 20, 9, 18], [25, 19, 7, 14, 28]], 31,
            compute_logicals=False)
        return code.checks.z, qc_kwargs_for_code(code, "z"), QCBPDecoder
    code = bivariate_bicycle_code(
        6, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)])
    return code.checks.z, qc_kwargs_for_code(code, "z"), BPDecoder


_FAMILIES = ("random_ldpc", "hgp", "qc_lp", "bb")


@pytest.fixture(scope="module")
def families():
    return {name: _family(name) for name in _FAMILIES}


@pytest.mark.parametrize("family", _FAMILIES)
def test_selection_picks(families, family):
    H, qc, cls = families[family]
    dec = make_bp_decoder(H, error_rate=0.01, **qc)
    assert type(dec) is cls


@pytest.mark.parametrize("early_stop", [True, False], ids=["early", "fixed"])
@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ms", 0.0), ("ps", 0.0)])
@pytest.mark.parametrize("family", _FAMILIES)
def test_selected_decoder_matches_numpy_oracle(families, family, method, msf,
                                               early_stop):
    """Convergence flags and iteration counts equal the oracle's exactly;
    hard decisions equal it on every shot both converged on.  Elsewhere
    only f32 summation order differs (the matmul and roll formulations add
    the check messages in another order than the oracle), which can move a
    sum-product posterior across zero on an unconverged shot, so overall
    hard-decision agreement is bounded at 95% of shots."""
    H, qc, _cls = families[family]
    Hd = np.asarray(H.toarray() if hasattr(H, "toarray") else H) % 2
    rng = np.random.default_rng(0)
    S = 48
    errs = (rng.random((S, Hd.shape[1])) < 0.03).astype(np.uint8)
    synd = (errs @ Hd.T) % 2
    kw = dict(error_rate=0.03, max_iter=16, bp_method=method,
              ms_scaling_factor=msf, early_stop=early_stop)
    h, _p, conv, iters = map(np.asarray,
                             make_bp_decoder(H, **qc, **kw).decode_batch(synd))
    ho, _po, co, io = NumpyBPDecoder.from_check_matrix(H, **kw).decode_batch(synd)
    np.testing.assert_array_equal(conv, co)
    np.testing.assert_array_equal(iters, io)
    both = conv & co
    np.testing.assert_array_equal(h[both], ho[both])
    assert (h == ho).all(axis=1).mean() >= 0.95
    ok = ((h.astype(np.int64) @ Hd.T) % 2 == synd).all(axis=1)
    np.testing.assert_array_equal(ok, conv)  # honest convergence flags
    assert conv.any()
