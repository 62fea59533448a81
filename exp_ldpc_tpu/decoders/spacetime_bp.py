"""Structured spacetime BP: exploit the block structure of multi-round decoding.

The spacetime check matrix (``decoders/spacetime.py``, reference
``/root/reference/python/qldpc/spacetime_code.py:39-75``) is (rounds+1)
copies of the base H on the diagonal plus measurement-error columns of
degree 2 linking consecutive rounds.  The generic BP kernel treats it as one
big Tanner graph — its one-hot routing operands grow with (rounds+1)² and the
matrix products multiply mostly structural zeros.  This module runs the SAME flooding
BP (bit-for-bit the same message math and schedule) in the factored form:

  * data-column messages live in a (B, r, Dc, S) tensor (B = rounds+1 round
    blocks); the variable update is the BASE code's small one-hot matmul
    pair, batched over the round axis — an (n, r·Dc) × (B·r·Dc, S) einsum;
  * each check gets TWO extra message slots for its incident measurement-
    error variables (previous/next round); the check update is the standard
    kernel on (B·r, Dc+2, S);
  * measurement variables have degree 2, so their update is closed-form
    elementwise math — no routing at all.

Work per iteration drops from O((B·n + R·r) · B·r·Dc') to B × the base-code
cost, an ~(rounds+1)× FLOP cut over the generic matmul formulation.

Column/row conventions match ``SpacetimeCode`` exactly: rows are round-major
blocks of r checks; columns are B·n data bits (round-major) followed by R·r
measurement bits; priors are per-column and arbitrary.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

from .bp import (
    _BIG,
    _build_dense_ops,
    _check_update_cm,
    _gather_flat,
    dense_ops_device,
    priors_to_llr,
    resolve_use_matmul,
)
from .tanner import TannerELL

__all__ = ["SpacetimeBPDecoder"]


@partial(
    jax.jit,
    static_argnames=(
        "tanner", "num_rounds", "method", "max_iter", "early_stop", "formulation", "msg_dtype",
    ),
)
def _stbp_core(
    tanner: TannerELL,
    num_rounds: int,
    prior_llr_st,
    syndromes,
    method: str,
    max_iter: int,
    ms_scaling_factor,
    early_stop: bool = True,
    formulation: str = "auto",
    dense_ops=None,
    msg_dtype: str = "float32",
):
    """Structured spacetime BP.

    tanner: base-code Tanner graph of H (r, n).  prior_llr_st: (B*n + R*r,)
    per-column LLRs in SpacetimeCode column order.  syndromes: (B*r, S) in
    SpacetimeCode row order.  Returns (hard (Vst, S) uint8, posterior
    (Vst, S), converged (S,) bool, iters (S,) int32).

    msg_dtype "bfloat16" stores messages in bf16 (accumulations stay f32):
    the spacetime check update streams the message tensor through device
    memory each iteration, so this halves its bytes at the cost of
    bit-exactness with the f32 oracle — statistically LER-neutral for
    min-sum (tests/test_spacetime_bp.py).
    """
    R = num_rounds
    B = R + 1
    r, n, Dc = tanner.num_checks, tanner.num_vars, tanner.max_check_degree
    S = syndromes.shape[1]
    mdt = jnp.dtype(msg_dtype)

    data_llr = prior_llr_st[: B * n].reshape(B, n)  # (B, n)
    meas_llr = prior_llr_st[B * n :].reshape(R, r)  # (R, r)

    synd = syndromes.reshape(B, r, S)
    synd_sign = (1.0 - 2.0 * synd.astype(jnp.float32)).astype(mdt)

    use_matmul = resolve_use_matmul(tanner, formulation)
    if use_matmul:
        if dense_ops is not None:
            M, G, Hd = dense_ops
            mask = _build_dense_ops(tanner)[3]
        else:
            M, G, Hd, mask = _build_dense_ops(tanner)
    else:
        mask = np.asarray(tanner.chk_mask)
    mask4 = jnp.asarray(mask)[None, :, :, None]  # (1, r, Dc, 1)

    # init v2c with per-column priors; padded slots neutral (+BIG)
    chk_vars = np.asarray(tanner.chk_vars)
    edge_prior = data_llr[:, chk_vars]  # (B, r, Dc) static gather
    edge_prior = jnp.where(jnp.asarray(tanner.chk_mask)[None], edge_prior, _BIG)
    v2c_data0 = jnp.broadcast_to(edge_prior[..., None].astype(mdt), (B, r, Dc, S))
    v2c_mlo0 = jnp.broadcast_to(meas_llr[..., None].astype(mdt), (R, r, S))
    v2c_mhi0 = v2c_mlo0

    adaptive = ms_scaling_factor == 0.0
    big_slot = jnp.full((1, r, S), _BIG, mdt)

    def step(it, msgs):
        v2c_data, v2c_mlo, v2c_mhi = msgs
        alpha = jnp.where(
            adaptive, 1.0 - 2.0 ** (-(it + 1).astype(jnp.float32)), ms_scaling_factor
        ).astype(mdt)
        # check block b sees m_{b-1,c} (that var's hi-edge) and m_{b,c} (lo-edge)
        slot_prev = jnp.concatenate([big_slot, v2c_mhi], axis=0)  # (B, r, S)
        slot_next = jnp.concatenate([v2c_mlo, big_slot], axis=0)  # (B, r, S)
        v2c_ext = jnp.concatenate(
            [v2c_data, slot_prev[:, :, None, :], slot_next[:, :, None, :]], axis=2
        )  # (B, r, Dc+2, S)
        c2v_ext = _check_update_cm(
            v2c_ext.reshape(B * r, Dc + 2, S), synd_sign.reshape(B * r, S), method, alpha
        ).reshape(B, r, Dc + 2, S)
        c2v_data = c2v_ext[:, :, :Dc, :]

        # data-variable update: base-code routing, batched over round blocks
        if use_matmul:
            # HIGHEST: these dots carry LLRs, which TF32 would otherwise round
            flat = c2v_data.reshape(B, r * Dc, S)
            totals = jnp.einsum("vk,bks->bvs", M, flat, preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
            posterior_d = data_llr[:, :, None] + totals  # (B, n, S) f32
            back = jnp.einsum(
                "kv,bvs->bks", G, posterior_d.astype(mdt),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            v2c_data_new = jnp.where(
                mask4, back.astype(mdt).reshape(B, r, Dc, S) - c2v_data, mdt.type(_BIG)
            )
        else:
            c2v_vm = jax.vmap(lambda x: _gather_flat(x, tanner.vm_from_cm, 0.0))(c2v_data)
            totals = jnp.sum(c2v_vm.astype(jnp.float32), axis=2)  # (B, n, S)
            posterior_d = data_llr[:, :, None] + totals
            v2c_vm = (posterior_d[:, :, None, :] - c2v_vm.astype(jnp.float32)).astype(mdt)
            v2c_data_new = jax.vmap(lambda x: _gather_flat(x, tanner.cm_from_vm, mdt.type(_BIG)))(v2c_vm)

        # measurement-variable update (degree 2, closed form)
        c2m_lo = c2v_ext[:R, :, Dc + 1, :].astype(jnp.float32)  # from check (i, c)
        c2m_hi = c2v_ext[1:, :, Dc, :].astype(jnp.float32)      # from check (i+1, c)
        posterior_m = meas_llr[:, :, None] + c2m_lo + c2m_hi  # (R, r, S) f32
        v2c_mlo_new = (posterior_m - c2m_lo).astype(mdt)
        v2c_mhi_new = (posterior_m - c2m_hi).astype(mdt)

        return (v2c_data_new, v2c_mlo_new, v2c_mhi_new), (posterior_d, posterior_m)

    zeros_slot = jnp.zeros((1, r, S), dtype=jnp.int32)

    def syndrome_ok(hard_d, hard_m):
        """(S,) bool: spacetime parity of the estimate equals the syndrome."""
        if use_matmul:
            # 0/1 x 0/1 parity counts: exact in TF32, default precision
            counts = jnp.einsum(
                "cv,bvs->bcs", Hd, hard_d.astype(jnp.float32),
                preferred_element_type=jnp.float32,
            )
            data_par = (counts - 2.0 * jnp.floor(counts * 0.5) > 0.5).astype(jnp.int32)
        else:
            bits = hard_d[:, chk_vars].astype(jnp.int32)  # (B, r, Dc, S)
            bits = jnp.where(jnp.asarray(tanner.chk_mask)[None, :, :, None], bits, 0)
            data_par = jnp.sum(bits, axis=2) % 2
        m_prev = jnp.concatenate([zeros_slot, hard_m.astype(jnp.int32)], axis=0)
        m_next = jnp.concatenate([hard_m.astype(jnp.int32), zeros_slot], axis=0)
        par = (data_par + m_prev + m_next) % 2
        return jnp.all(par == synd.astype(jnp.int32), axis=(0, 1))

    def flatten(posterior_d, posterior_m):
        posterior = jnp.concatenate(
            [posterior_d.reshape(B * n, S), posterior_m.reshape(R * r, S)], axis=0
        )
        return (posterior <= 0).astype(jnp.uint8), posterior

    msgs0 = (v2c_data0, v2c_mlo0, v2c_mhi0)
    posterior0 = jnp.broadcast_to(prior_llr_st[:, None], (B * n + R * r, S))

    if not early_stop:
        def fbody(it, carry):
            msgs, _post = carry
            msgs, (pd, pm) = step(it, msgs)
            return msgs, (pd, pm)

        pd0 = jnp.broadcast_to(data_llr[:, :, None], (B, n, S))
        pm0 = jnp.broadcast_to(meas_llr[:, :, None], (R, r, S))
        _msgs, (pd, pm) = jax.lax.fori_loop(0, max_iter, fbody, (msgs0, (pd0, pm0)))
        hard, posterior = flatten(pd, pm)
        conv = syndrome_ok((pd <= 0).astype(jnp.uint8), (pm <= 0).astype(jnp.uint8))
        iters = jnp.full((S,), max_iter, dtype=jnp.int32)
        return hard, posterior, conv, iters

    hard0 = (posterior0 <= 0).astype(jnp.uint8)
    converged0 = jnp.zeros((S,), dtype=bool)
    iters0 = jnp.zeros((S,), dtype=jnp.int32)

    def cond(state):
        it, _msgs, _hard, _post, conv, _iters = state
        return (it < max_iter) & ~jnp.all(conv)

    def body(state):
        it, msgs, hard, post, conv, iters = state
        msgs, (pd, pm) = step(it, msgs)
        hard_new, posterior = flatten(pd, pm)
        ok = syndrome_ok((pd <= 0).astype(jnp.uint8), (pm <= 0).astype(jnp.uint8))
        # freeze each shot's outputs at its first convergence (ldpc semantics)
        hard = jnp.where(conv[None, :], hard, hard_new)
        post = jnp.where(conv[None, :], post, posterior)
        iters = jnp.where(conv, iters, it + 1)
        conv = conv | ok
        return (it + 1, msgs, hard, post, conv, iters)

    state = (jnp.int32(0), msgs0, hard0, posterior0, converged0, iters0)
    _, _, hard, post, conv, iters = jax.lax.while_loop(cond, body, state)
    return hard, post, conv, iters


@dataclass
class SpacetimeBPDecoder:
    """Batched BP over a multi-round spacetime matrix, in structured form.

    API-compatible with :class:`~exp_ldpc_tpu.decoders.bp.BPDecoder` (so it
    drops into :class:`~exp_ldpc_tpu.decoders.bposd.BPOSDDecoder` as the
    ``bp`` stage): ``decode_batch`` takes (S, B·r) syndromes in SpacetimeCode
    row order and returns spacetime-column-ordered outputs.
    """

    tanner: TannerELL  # base code H
    num_rounds: int
    prior_llr: np.ndarray  # (B*n + R*r,)
    max_iter: int
    method: str = "ps"
    ms_scaling_factor: float = 0.0
    formulation: str = "auto"
    msg_dtype: str = "float32"
    # per-shot early stop freezes each shot at first convergence (ldpc
    # semantics); False = fixed-iteration flooding
    early_stop: bool = True

    def __post_init__(self):
        method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}.get(self.method)
        if method is None:
            raise ValueError(f"unknown bp method {self.method!r}")
        object.__setattr__(self, "method", method)

    @classmethod
    def from_check_matrix(
        cls,
        H,
        num_rounds: int,
        *,
        error_rate: Optional[float] = None,
        channel_probs: Optional[np.ndarray] = None,
        max_iter: int = 0,
        bp_method: str = "ps",
        ms_scaling_factor: float = 0.0,
        formulation: str = "auto",
        msg_dtype: str = "float32",
        early_stop: bool = True,
        **_ignored,
    ) -> "SpacetimeBPDecoder":
        """H is the BASE check matrix (r, n); priors are per spacetime column
        ((rounds+1)·n data + rounds·r measurement), or a scalar error_rate."""
        H = sparse.csr_matrix(H)
        r, n = H.shape
        n_st = (num_rounds + 1) * n + num_rounds * r
        if channel_probs is not None:
            priors = np.asarray(channel_probs, dtype=np.float64)
            if priors.shape != (n_st,):
                raise ValueError(f"channel_probs must have shape ({n_st},)")
        elif error_rate is not None:
            priors = np.full(n_st, error_rate)
        else:
            raise ValueError("need error_rate or channel_probs")
        tanner = TannerELL.from_check_matrix(H)
        if max_iter <= 0:  # ldpc convention (matches BPDecoder): default = n
            max_iter = n_st
        return cls(
            tanner=tanner,
            num_rounds=num_rounds,
            prior_llr=priors_to_llr(priors),
            max_iter=max_iter,
            method=bp_method,
            ms_scaling_factor=ms_scaling_factor,
            formulation=formulation,
            msg_dtype=msg_dtype,
            early_stop=early_stop,
        )

    def decode_batch(self, syndromes: np.ndarray):
        """(S, (R+1)·r) syndromes -> (hard (S, Vst), posterior (S, Vst),
        converged (S,), iters (S,))."""
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        dense_ops = (
            dense_ops_device(self.tanner)
            if resolve_use_matmul(self.tanner, self.formulation)
            else None
        )
        hard, post, conv, iters = _stbp_core(
            self.tanner,
            self.num_rounds,
            jnp.asarray(self.prior_llr),
            jnp.asarray(syndromes.T),
            self.method,
            self.max_iter,
            jnp.float32(self.ms_scaling_factor),
            self.early_stop,
            self.formulation,
            dense_ops,
            self.msg_dtype,
        )
        return (
            np.asarray(hard).T,
            np.asarray(post).T,
            np.asarray(conv),
            np.asarray(iters),
        )

    def decode(self, syndrome: np.ndarray):
        hard, _post, _conv, _iters = self.decode_batch(np.asarray(syndrome)[None, :])
        return hard[0]
