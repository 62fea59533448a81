"""QC-structured BP: block detection, parity with the generic BP kernel,
early-stop semantics (decoders/qc_bp.py)."""
import numpy as np
import pytest

from exp_ldpc_tpu.codes.bivariate_bicycle import bivariate_bicycle_code
from exp_ldpc_tpu.codes.qc_lifted import qc_lifted_product_code
from exp_ldpc_tpu.decoders.bp import BPDecoder
from exp_ldpc_tpu.decoders.qc_bp import QCBPDecoder, QCStructure


@pytest.fixture(scope="module")
def bb72():
    return bivariate_bicycle_code(
        6, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)]
    )


def test_structure_detection_bb(bb72):
    st = QCStructure.from_check_matrix(bb72.checks.z, (6, 6))
    assert (st.num_check_blocks, st.num_var_blocks) == (1, 2)
    assert len(st.monomials) == 6  # B^T and A^T, three terms each
    assert st.num_checks == 36 and st.num_vars == 72
    # reconstruct H from the detected monomials
    H = np.zeros((st.num_checks, st.num_vars), np.uint8)
    for i, j, (s1, s2) in st.monomials:
        m = np.kron(
            np.roll(np.eye(6, dtype=np.uint8), s1, axis=1),
            np.roll(np.eye(6, dtype=np.uint8), s2, axis=1),
        )
        H[i * 36:(i + 1) * 36, j * 36:(j + 1) * 36] ^= m
    np.testing.assert_array_equal(H, bb72.checks.z.toarray() % 2)


def test_structure_detection_qclp():
    shifts = [[1, 2, 4, 8, 16], [5, 10, 20, 9, 18], [25, 19, 7, 14, 28]]
    code = qc_lifted_product_code(shifts, 31)
    st = QCStructure.from_check_matrix(code.checks.z, (31,))
    assert st.num_vars == 1054
    assert st.block_size == 31


def test_structure_rejects_non_qc(bb72):
    H = bb72.checks.z.toarray().copy()
    H[0, 0] ^= 1  # break the circulant structure
    with pytest.raises(ValueError):
        QCStructure.from_check_matrix(H, (6, 6))
    with pytest.raises(ValueError):
        QCStructure.from_check_matrix(bb72.checks.z, (5, 6))  # wrong dims


@pytest.mark.parametrize("method,msf", [("ms", 0.625), ("ps", 0.0), ("ms", 0.0)])
def test_qc_matches_generic_bp(bb72, method, msf):
    Hz = bb72.checks.z
    rng = np.random.default_rng(1)
    S = 64
    errs = (rng.random((S, Hz.shape[1])) < 0.02).astype(np.uint8)
    synd = (errs @ Hz.T.toarray()) % 2
    kw = dict(error_rate=0.02, max_iter=30, bp_method=method,
              ms_scaling_factor=msf)
    qh, qp, qc_, qi = QCBPDecoder.from_check_matrix(Hz, (6, 6), **kw).decode_batch(synd)
    rh, rp, rc, ri = BPDecoder.from_check_matrix(Hz, **kw).decode_batch(synd)
    qh, qp, rh, rp = map(np.asarray, (qh, qp, rh, rp))
    # identical flooding math; formulations differ only in f32 association
    assert (qh == rh).mean() >= 0.999
    assert (np.asarray(qc_) == np.asarray(rc)).mean() >= 0.95
    assert (np.asarray(qi) == np.asarray(ri)).mean() >= 0.95
    # convergence claims are honest
    ok = ((qh @ Hz.T.toarray()) % 2 == synd).all(axis=1)
    assert (ok == np.asarray(qc_)).all()


def test_qc_fixed_iteration_mode(bb72):
    Hz = bb72.checks.z
    rng = np.random.default_rng(2)
    synd = (rng.random((8, Hz.shape[0])) < 0.1).astype(np.uint8)
    dec = QCBPDecoder.from_check_matrix(
        Hz, (6, 6), error_rate=0.01, max_iter=9, bp_method="ms",
        ms_scaling_factor=0.625, early_stop=False,
    )
    _h, _p, _c, iters = dec.decode_batch(synd)
    assert (np.asarray(iters) == 9).all()


def test_qc_option_validation(bb72):
    Hz = bb72.checks.z
    with pytest.raises(ValueError):
        QCBPDecoder.from_check_matrix(Hz, (6, 6))  # no prior
    with pytest.raises(ValueError):
        QCBPDecoder.from_check_matrix(Hz, (6, 6), channel_probs=np.full(3, 0.1))
    with pytest.raises(ValueError):
        QCBPDecoder.from_check_matrix(Hz, (6, 6), error_rate=0.1, bp_method="xx")


def test_abelian_lp_metadata_and_perm_parity():
    """An abelian (Z_q) lifted product is block-circulant after the
    constructor's recorded axis permutation, and the permuted QC decoder
    matches generic BP bit-exactly on converged shots."""
    from exp_ldpc_tpu.codes.lifted import lifted_product_code_cyclic

    code = lifted_product_code_cyclic(q=6, m=1, w=4, r=2, seed=3,
                                      compute_logicals=False)
    meta = code.qc_meta
    assert meta is not None and meta.dims == (6,)
    for H, perm in ((code.checks.z, meta.z_check_perm),
                    (code.checks.x, meta.x_check_perm)):
        QCStructure.from_check_matrix(H[perm][:, meta.qubit_perm], meta.dims)

    Hz = code.checks.z
    rng = np.random.default_rng(0)
    errs = (rng.random((64, Hz.shape[1])) < 0.02).astype(np.uint8)
    synd = (errs @ Hz.T.toarray()) % 2
    kw = dict(error_rate=0.02, max_iter=24, bp_method="ms",
              ms_scaling_factor=0.625)
    qc = QCBPDecoder.from_check_matrix(
        Hz, meta.dims, check_perm=meta.z_check_perm,
        var_perm=meta.qubit_perm, **kw)
    ref = BPDecoder.from_check_matrix(Hz, **kw)
    qh, _qp, qcv, _qi = map(np.asarray, qc.decode_batch(synd))
    rh, _rp, rcv, _ri = map(np.asarray, ref.decode_batch(synd))
    assert (qcv == rcv).all()
    assert (qh[qcv] == rh[rcv]).all()
    # outputs are in ORIGINAL column order: syndrome validity on converged
    ok = ((qh @ Hz.T.toarray()) % 2 == synd).all(axis=1)
    assert (ok == qcv).all()


def test_make_bp_decoder_routing(bb72):
    from exp_ldpc_tpu.decoders.select import (
        make_bp_decoder, qc_kwargs_for_code, qc_kwargs_single_shot)
    from scipy import sparse

    # small QC codes stay on the generic one-hot matmul formulation
    # (below the dense-operand threshold)
    dec = make_bp_decoder(bb72.checks.z, error_rate=0.01,
                          **qc_kwargs_for_code(bb72, "z"))
    assert isinstance(dec, BPDecoder)
    # above the threshold the roll kernel takes over
    shifts = [[1, 2, 4, 8, 16], [5, 10, 20, 9, 18], [25, 19, 7, 14, 28]]
    big = qc_lifted_product_code(shifts, 31, compute_logicals=False)
    dec = make_bp_decoder(big.checks.z, error_rate=0.01,
                          **qc_kwargs_for_code(big, "z"))
    assert isinstance(dec, QCBPDecoder)
    # no metadata -> generic decoder
    dec = make_bp_decoder(big.checks.z, error_rate=0.01)
    assert isinstance(dec, BPDecoder)
    # single-shot (H|I) stays QC (identity block = circulant)
    kws = qc_kwargs_single_shot(big, "z")
    Hz = big.checks.z
    HI = sparse.hstack([Hz, sparse.identity(Hz.shape[0], dtype=np.uint8)]).tocsr()
    dec = make_bp_decoder(HI, error_rate=0.01, **kws)
    assert isinstance(dec, QCBPDecoder)


def test_qc_metadata_attached():
    from exp_ldpc_tpu.codes.qc_lifted import qc_lifted_product_code

    shifts = [[0, 1], [2, 3]]
    code = qc_lifted_product_code(shifts, 5)
    assert code.qc_meta.dims == (5,)
    QCStructure.from_check_matrix(code.checks.z, (5,))


def test_qc_drops_into_bposd(bb72):
    from exp_ldpc_tpu.decoders.bposd import BPOSDDecoder
    from scipy import sparse

    Hz = bb72.checks.z
    rng = np.random.default_rng(3)
    errs = (rng.random((32, Hz.shape[1])) < 0.03).astype(np.uint8)
    synd = (errs @ Hz.T.toarray()) % 2
    bp = QCBPDecoder.from_check_matrix(
        Hz, (6, 6), error_rate=0.03, max_iter=20, bp_method="ms",
        ms_scaling_factor=0.625,
    )
    dec = BPOSDDecoder(bp=bp, H=sparse.csr_matrix(Hz), osd_method="osd_cs",
                       osd_order=4)
    hard = dec.decode_batch(synd)
    assert (((hard @ Hz.T.toarray()) % 2) == synd).all()
