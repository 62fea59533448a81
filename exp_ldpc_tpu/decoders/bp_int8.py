"""Quantized (int8) min-sum BP — the lower-precision fast path.

The f32 matmul-routing kernel (``bp.py``) has an arithmetic intensity of
~56 FLOP/byte, so halving only bytes (bf16 messages) or only matmul cost
(bf16 operands) may move little — both levers have to drop together.  This
kernel does that: messages are int8 fixed-point LLRs, the 0/1 routing
operands are int8, and the routing matmuls accumulate in int32 while
device-memory traffic drops 4x.  Nothing about its speed on the GPU has
been measured (ROADMAP Design 2).  Fixed-point min-sum with 5-6
significant bits is the standard construction in LDPC ASIC/FPGA decoders
and is known to cost almost nothing in logical accuracy; the scaling factor is applied exactly
as a rational (num / 2^shift) so the whole iteration is integer math —
bit-exactly reproducible by the numpy oracle in ``int8_bp_oracle``.

Semantics mirror ``decoders/bp.py`` (the ldpc ``bp_decoder`` contract,
reference ``/root/reference/python/qldpc/misc/_experiment.py:213-229``):
per-column priors, early stopping that freezes each shot at first
convergence, min-sum with scaling.  Product-sum is not offered — the phi
transform has no useful fixed-point form at this width; callers wanting
``ps`` use the f32 kernel.

Quantization: LLRs are scaled by ``delta = max(prior_llr) / prior_quanta``
so the largest prior maps to ``prior_quanta`` (default 24) int8 quanta.
Posteriors saturate at +/-127 (saturation, not wraparound — the clamp is
explicit).  The variable update excludes self against the SATURATED
posterior, as fixed-point decoders do; at these widths the difference from
the unsaturated exclusion is below the quantization floor.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bp import _build_dense_ops, priors_to_llr
from .tanner import TannerELL

__all__ = ["Int8BPDecoder", "quantize_priors", "int8_bp_oracle"]

_SAT = 127  # saturation magnitude; -128 never occurs
_ALPHA_SHIFT = 8


def quantize_priors(prior_llr: np.ndarray, prior_quanta: int = 24):
    """LLR priors -> (int32 quanta, delta).  delta = LLR units per quantum."""
    prior_llr = np.asarray(prior_llr, dtype=np.float64)
    delta = float(prior_llr.max()) / float(prior_quanta)
    if delta <= 0:
        raise ValueError("priors must contain a positive LLR")
    q = np.clip(np.rint(prior_llr / delta), -_SAT, _SAT).astype(np.int32)
    return q, delta


@lru_cache(maxsize=32)
def _int8_dense_ops(tanner: TannerELL):
    """int8 casts of the 0/1 routing operands, as device arrays."""
    M, G, Hd, _mask = _build_dense_ops(tanner)
    return (
        jax.device_put(M.astype(np.int8)),
        jax.device_put(G.astype(np.int8)),
        jax.device_put(Hd.astype(np.int8)),
    )


def _check_update_int(v2c, synd_one, alpha_num):
    """Min-sum check update on int8 messages in check-major (C, Dc, S).

    Padded slots hold +_SAT (sign +, min-inert).  Returns int8 c2v; padded
    output slots hold garbage that the routing matmul's zero columns drop.
    """
    neg = v2c < 0
    mag = jnp.abs(v2c.astype(jnp.int32))
    # parity of sign bits per check, xor the syndrome bit
    total_neg = (jnp.sum(neg, axis=1, keepdims=True) + synd_one[:, None, :]) % 2
    ext_neg = (total_neg + neg) % 2 == 1  # parity excluding self
    min1 = jnp.min(mag, axis=1, keepdims=True)
    is_min = (mag == min1) & (jnp.cumsum(mag == min1, axis=1) == 1)
    min2 = jnp.min(jnp.where(is_min, _SAT + 1, mag), axis=1, keepdims=True)
    ext = jnp.where(is_min, min2, min1)
    scaled = (ext * alpha_num) >> _ALPHA_SHIFT  # exact rational scaling
    return jnp.where(ext_neg, -scaled, scaled).astype(jnp.int8)


@partial(jax.jit, static_argnames=("tanner", "max_iter", "early_stop"))
def _int8_bp_core(tanner: TannerELL, prior_q, syndromes, max_iter: int,
                  alpha_num, early_stop: bool, dense_ops):
    """syndromes (C, S) uint8; prior_q (V,) int32 quanta.  Returns
    (hard (V,S) uint8, posterior (V,S) int32 quanta, converged (S,) bool,
    iters (S,) int32)."""
    C, S = syndromes.shape
    V, Dc = tanner.num_vars, tanner.max_check_degree
    synd_one = syndromes.astype(jnp.int32)
    M8, G8, Hd8 = dense_ops
    mask = jnp.asarray(_build_dense_ops(tanner)[3])
    mask3 = mask[:, :, None]

    prior8 = jnp.clip(prior_q, -_SAT, _SAT).astype(jnp.int8)
    edge_prior = prior8[np.asarray(tanner.chk_vars)]
    edge_prior = jnp.where(jnp.asarray(tanner.chk_mask), edge_prior,
                           jnp.int8(_SAT))
    v2c0 = jnp.broadcast_to(edge_prior[:, :, None], (C, Dc, S))

    def step(v2c):
        c2v = _check_update_int(v2c, synd_one, alpha_num)
        totals = jnp.dot(M8, c2v.reshape(C * Dc, S),
                         preferred_element_type=jnp.int32)
        posterior = prior_q[:, None] + totals  # (V, S) int32 quanta
        post8 = jnp.clip(posterior, -_SAT, _SAT).astype(jnp.int8)
        back = jnp.dot(G8, post8, preferred_element_type=jnp.int32)
        v2c_new = jnp.clip(back.reshape(C, Dc, S) - c2v.astype(jnp.int32),
                           -_SAT, _SAT)
        v2c_new = jnp.where(mask3, v2c_new, _SAT).astype(jnp.int8)
        return v2c_new, posterior

    def syndrome_ok(hard):
        counts = jnp.dot(Hd8, hard.astype(jnp.int8),
                         preferred_element_type=jnp.int32)
        return jnp.all(counts % 2 == synd_one, axis=0)

    posterior0 = jnp.broadcast_to(prior_q[:, None], (V, S))

    if not early_stop:
        def fbody(_it, carry):
            v2c, _post = carry
            return step(v2c)

        _v2c, posterior = jax.lax.fori_loop(0, max_iter, fbody,
                                            (v2c0, posterior0))
        hard = (posterior <= 0).astype(jnp.uint8)
        return hard, posterior, syndrome_ok(hard), jnp.full(
            (S,), max_iter, dtype=jnp.int32)

    hard0 = jnp.zeros((V, S), dtype=jnp.uint8)
    conv0 = jnp.zeros((S,), dtype=bool)
    iters0 = jnp.zeros((S,), dtype=jnp.int32)

    def cond(state):
        it, _v2c, _hard, _post, conv, _iters = state
        return (it < max_iter) & ~jnp.all(conv)

    def body(state):
        it, v2c, hard, post, conv, iters = state
        v2c_new, posterior = step(v2c)
        hard_new = (posterior <= 0).astype(jnp.uint8)
        ok = syndrome_ok(hard_new)
        hard = jnp.where(conv[None, :], hard, hard_new)
        post = jnp.where(conv[None, :], post, posterior)
        iters = jnp.where(conv, iters, it + 1)
        conv = conv | ok
        return (it + 1, v2c_new, hard, post, conv, iters)

    state = (jnp.int32(0), v2c0, hard0, posterior0, conv0, iters0)
    _, _, hard, post, conv, iters = jax.lax.while_loop(cond, body, state)
    return hard, post, conv, iters


def int8_bp_oracle(H, prior_q, syndromes, max_iter: int, alpha_num: int):
    """Bit-exact numpy mirror of ``_int8_bp_core`` (fixed-iteration path).

    Integer math is order-independent, so this reproduces the device kernel
    exactly — the parity test in ``tests/test_bp_int8.py`` asserts identical
    posteriors, not just hard decisions.
    """
    from scipy import sparse

    tanner = TannerELL.from_check_matrix(H)
    C, V, Dc = tanner.num_checks, tanner.num_vars, tanner.max_check_degree
    syndromes = np.asarray(syndromes, dtype=np.int64)  # (C, S)
    S = syndromes.shape[1]
    chk_vars, chk_mask = tanner.chk_vars, tanner.chk_mask
    prior_q = np.asarray(prior_q, dtype=np.int64)
    Hd = sparse.csr_matrix(H).toarray().astype(np.int64)

    edge_prior = np.clip(prior_q, -_SAT, _SAT)[chk_vars]
    v2c = np.where(chk_mask, edge_prior, _SAT)[:, :, None] * np.ones(
        (1, 1, S), dtype=np.int64)
    posterior = np.broadcast_to(prior_q[:, None], (V, S)).copy()

    for _ in range(max_iter):
        neg = v2c < 0
        mag = np.abs(v2c)
        total_neg = (neg.sum(axis=1, keepdims=True) + syndromes[:, None, :]) % 2
        ext_neg = (total_neg + neg) % 2 == 1
        min1 = mag.min(axis=1, keepdims=True)
        is_min = (mag == min1) & (np.cumsum(mag == min1, axis=1) == 1)
        min2 = np.where(is_min, _SAT + 1, mag).min(axis=1, keepdims=True)
        ext = np.where(is_min, min2, min1)
        scaled = (ext * alpha_num) >> _ALPHA_SHIFT
        c2v = np.where(ext_neg, -scaled, scaled)
        c2v = np.where(chk_mask[:, :, None], c2v, 0)  # matmul drops pads

        totals = np.zeros((V, S), dtype=np.int64)
        np.add.at(totals, chk_vars.reshape(-1),
                  c2v.reshape(C * Dc, S))
        # padded chk_vars slots are 0 but their c2v was zeroed above
        posterior = prior_q[:, None] + totals
        post8 = np.clip(posterior, -_SAT, _SAT)
        v2c = np.clip(post8[chk_vars] - c2v, -_SAT, _SAT)
        v2c = np.where(chk_mask[:, :, None], v2c, _SAT)

    hard = (posterior <= 0).astype(np.uint8)
    conv = ((Hd @ hard) % 2 == syndromes).all(axis=0)
    return hard, posterior, conv


@dataclass
class Int8BPDecoder:
    """Quantized min-sum BP with the ``BPDecoder`` decode contract.

    Same (S, C) -> (S, V) batch interface; ``posterior`` is returned in LLR
    units (quanta * delta) so downstream OSD ranking sees the usual scale.
    """

    tanner: TannerELL
    prior_q: np.ndarray
    delta: float
    max_iter: int = 0
    ms_scaling_factor: float = 0.625
    early_stop: bool = True

    def __post_init__(self):
        if self.max_iter <= 0:
            object.__setattr__(self, "max_iter", self.tanner.num_vars)
        if not 0 < self.ms_scaling_factor <= 1:
            raise ValueError("int8 BP needs a fixed scaling factor in (0, 1]")

    @property
    def alpha_num(self) -> int:
        return int(round(self.ms_scaling_factor * (1 << _ALPHA_SHIFT)))

    @classmethod
    def from_check_matrix(
        cls,
        H,
        *,
        error_rate: Optional[float] = None,
        channel_probs: Optional[np.ndarray] = None,
        max_iter: int = 0,
        ms_scaling_factor: float = 0.625,
        early_stop: bool = True,
        prior_quanta: int = 24,
        **_ignored,
    ) -> "Int8BPDecoder":
        tanner = TannerELL.from_check_matrix(H)
        if channel_probs is not None:
            prior = np.asarray(channel_probs, dtype=np.float64)
        elif error_rate is not None:
            prior = np.full(tanner.num_vars, error_rate, dtype=np.float64)
        else:
            raise ValueError("must supply error_rate or channel_probs")
        q, delta = quantize_priors(priors_to_llr(prior), prior_quanta)
        return cls(
            tanner=tanner,
            prior_q=q,
            delta=delta,
            max_iter=max_iter,
            ms_scaling_factor=float(ms_scaling_factor),
            early_stop=early_stop,
        )

    def decode_batch(self, syndromes: np.ndarray):
        syndromes = jnp.asarray(syndromes, dtype=jnp.uint8).T  # (C, S)
        hard, post, conv, iters = _int8_bp_core(
            self.tanner,
            jnp.asarray(self.prior_q),
            syndromes,
            self.max_iter,
            jnp.int32(self.alpha_num),
            self.early_stop,
            _int8_dense_ops(self.tanner),
        )
        return hard.T, post.T.astype(jnp.float32) * self.delta, conv, iters

    def decode(self, syndrome: np.ndarray):
        hard, _post, _conv, _it = self.decode_batch(
            np.asarray(syndrome)[None, :])
        return np.asarray(hard[0])
