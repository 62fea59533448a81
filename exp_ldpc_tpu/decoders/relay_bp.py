"""Relay / disordered-memory BP: a fully-parallel alternative to BP+OSD.

OSD post-processing (the reference's accuracy workhorse via the ``ldpc``
package, ``/root/reference/python/qldpc/misc/_experiment.py:218-219``) is
per-shot Gaussian elimination — inherently serial and host-bound.  The
fully-parallelized decoding literature (see PAPERS.md: "Fully Parallelized
BP Decoding for Quantum LDPC Codes Can Outperform BP-OSD",
arXiv:2507.00254) replaces it with ENSEMBLES of memory-BP runs:

  * the variable-node posterior gets a per-variable memory term
        Lambda_j(t) = (1 - gamma_j) * (prior_j + sum_i c2v_ij)
                      + gamma_j * Lambda_j(t-1)
    and v2c messages subtract the incident c2v from Lambda as usual;
  * gamma_j = gamma0 (uniform) on the first leg; subsequent "relay" legs
    re-draw DISORDERED per-variable memory strengths gamma_j from a seeded
    uniform range (negative values allowed — they act as oscillation
    dampers) while message state carries over, so each leg explores a
    different fixed-point basin;
  * each shot keeps the first syndrome-satisfying solution it encounters
    (optionally continuing to collect several and keeping the lightest).

Everything is elementwise + the same matmul/gather routing as
:mod:`exp_ldpc_tpu.decoders.bp`, so the whole ensemble decodes the full shot
batch in ONE fused XLA program — no host round-trips, no per-shot loops.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

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

__all__ = ["RelayBPDecoder", "relay_bp_decode_batch"]


@partial(jax.jit, static_argnames=("tanner", "method", "num_legs",
                                   "iters_per_leg", "formulation"))
def _relay_core(tanner: TannerELL, prior_llr, syndromes, gammas, method: str,
                num_legs: int, iters_per_leg: int, ms_scaling_factor,
                formulation: str = "auto", dense_ops=None):
    """syndromes: (C, S) uint8; gammas: (num_legs, V) f32 memory strengths.

    Returns (hard (V,S) uint8, posterior (V,S) f32, converged (S,) bool,
    solved_leg (S,) int32 — leg index that first satisfied the syndrome,
    num_legs if none did)."""
    C, S = syndromes.shape
    V = tanner.num_vars
    Dc = tanner.max_check_degree
    synd_sign = 1.0 - 2.0 * syndromes.astype(jnp.float32)

    use_matmul = resolve_use_matmul(tanner, formulation)
    if use_matmul:
        if dense_ops is not None:
            M, G, Hd = dense_ops  # traced args: no giant HLO constants
            mask = _build_dense_ops(tanner)[3]
        else:
            M, G, Hd, mask = _build_dense_ops(tanner)
            M, G, Hd = jnp.asarray(M), jnp.asarray(G), jnp.asarray(Hd)
        mask3 = jnp.asarray(mask)[:, :, None]
    chk_vars = jnp.asarray(tanner.chk_vars)

    edge_prior = prior_llr[np.asarray(tanner.chk_vars)]
    edge_prior = jnp.where(jnp.asarray(tanner.chk_mask), edge_prior, _BIG)
    v2c0 = jnp.broadcast_to(edge_prior[:, :, None], (C, Dc, S))

    alpha = jnp.float32(ms_scaling_factor)
    adaptive = ms_scaling_factor == 0.0

    # HIGHEST on the routing dots: they carry LLRs, which TF32 would
    # otherwise round
    def totals_of(c2v):
        if use_matmul:
            return jnp.dot(M, c2v.reshape(C * Dc, S),
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        c2v_vm = _gather_flat(c2v, tanner.vm_from_cm, 0.0)
        return jnp.sum(c2v_vm, axis=1)

    def route_back(lam, c2v):
        if use_matmul:
            back = jnp.dot(G, lam, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            return jnp.where(mask3, back.reshape(C, Dc, S) - c2v, _BIG)
        return jnp.where(
            jnp.asarray(tanner.chk_mask)[:, :, None], lam[chk_vars] - c2v, _BIG)

    def syndrome_ok(hard):
        if use_matmul:
            # 0/1 x 0/1 parity counts: exact in TF32, default precision
            counts = jnp.dot(Hd, hard.astype(jnp.float32),
                             preferred_element_type=jnp.float32)
            par = counts - 2.0 * jnp.floor(counts * 0.5)
            return jnp.all((par > 0.5) == (syndromes > 0), axis=0)
        bits = jnp.where(jnp.asarray(tanner.chk_mask)[:, :, None],
                         hard[chk_vars], 0).astype(jnp.int32)
        return jnp.all(jnp.sum(bits, axis=1) % 2 == syndromes, axis=0)

    def leg_iter(it, carry, gamma):
        v2c, lam = carry
        a = jnp.where(adaptive, 1.0 - 2.0 ** (-(it + 1).astype(jnp.float32)), alpha)
        c2v = _check_update_cm(v2c, synd_sign, method, a)
        posterior = prior_llr[:, None] + totals_of(c2v)  # (V, S)
        lam_new = (1.0 - gamma)[:, None] * posterior + gamma[:, None] * lam
        v2c_new = route_back(lam_new, c2v)
        return v2c_new, lam_new

    def run_leg(leg, state):
        v2c, lam, hard, post, conv, solved_leg = state
        gamma = gammas[leg]  # (V,)

        def body(it, carry):
            return leg_iter(it, carry, gamma)

        v2c, lam = jax.lax.fori_loop(0, iters_per_leg, body, (v2c, lam))
        hard_new = (lam <= 0).astype(jnp.uint8)
        ok = syndrome_ok(hard_new)
        newly = ok & ~conv
        hard = jnp.where(newly[None, :], hard_new, hard)
        post = jnp.where(newly[None, :], lam, post)
        solved_leg = jnp.where(newly, leg, solved_leg)
        conv = conv | ok
        return v2c, lam, hard, post, conv, solved_leg

    lam0 = jnp.broadcast_to(prior_llr[:, None], (V, S))
    hard0 = jnp.zeros((V, S), dtype=jnp.uint8)
    conv0 = jnp.zeros((S,), dtype=bool)
    solved0 = jnp.full((S,), num_legs, dtype=jnp.int32)
    state = (v2c0, lam0, hard0, lam0, conv0, solved0)

    def cond(carry):
        leg, state = carry
        return (leg < num_legs) & ~jnp.all(state[4])

    def body(carry):
        leg, state = carry
        return leg + 1, run_leg(leg, state)

    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    v2c, lam, hard, post, conv, solved_leg = state
    # shots never converged: report the final leg's lambda/hard decision
    hard = jnp.where(conv[None, :], hard, (lam <= 0).astype(jnp.uint8))
    post = jnp.where(conv[None, :], post, lam)
    return hard, post, conv, solved_leg


@dataclass
class RelayBPDecoder:
    """Batched relay (disordered-memory) BP ensemble decoder.

    ``num_legs`` memory-BP legs of ``iters_per_leg`` flooding iterations
    each; leg 0 uses the uniform ``gamma0``, later legs draw per-variable
    gammas uniformly from ``gamma_range`` with the given ``seed``.
    ``decode_batch`` mirrors :class:`exp_ldpc_tpu.decoders.bp.BPDecoder`
    and additionally returns the per-shot solving-leg index.
    """

    tanner: TannerELL
    prior_llr: np.ndarray
    method: str = "ms"
    num_legs: int = 8
    iters_per_leg: int = 30
    gamma0: float = 0.65
    gamma_range: Tuple[float, float] = (-0.25, 0.85)
    ms_scaling_factor: float = 1.0
    seed: int = 0
    formulation: str = "auto"
    _gammas: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}.get(self.method)
        if method is None:
            raise ValueError(f"unknown bp method {self.method!r}")
        self.method = method
        rng = np.random.default_rng(self.seed)
        g = rng.uniform(self.gamma_range[0], self.gamma_range[1],
                        size=(self.num_legs, self.tanner.num_vars))
        g[0, :] = self.gamma0
        self._gammas = g.astype(np.float32)

    @classmethod
    def from_check_matrix(cls, H, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None,
                          **kw) -> "RelayBPDecoder":
        tanner = TannerELL.from_check_matrix(H)
        if channel_probs is not None:
            prior = np.asarray(channel_probs, dtype=np.float64)
        elif error_rate is not None:
            prior = np.full(tanner.num_vars, error_rate, dtype=np.float64)
        else:
            raise ValueError("must supply error_rate or channel_probs")
        return cls(tanner=tanner, prior_llr=priors_to_llr(prior), **kw)

    def decode_batch(self, syndromes: np.ndarray):
        syndromes = jnp.asarray(syndromes, dtype=jnp.uint8).T  # (C, S)
        hard, post, conv, leg = _relay_core(
            self.tanner,
            jnp.asarray(self.prior_llr),
            syndromes,
            jnp.asarray(self._gammas),
            self.method,
            self.num_legs,
            self.iters_per_leg,
            jnp.float32(self.ms_scaling_factor),
            self.formulation,
            dense_ops_device(self.tanner)
            if resolve_use_matmul(self.tanner, self.formulation) else None,
        )
        return hard.T, post.T, conv, leg

    def decode(self, syndrome: np.ndarray):
        hard, _post, _conv, _leg = self.decode_batch(np.asarray(syndrome)[None, :])
        return np.asarray(hard[0])


def relay_bp_decode_batch(H, syndromes, **kw):
    return RelayBPDecoder.from_check_matrix(H, **kw).decode_batch(syndromes)
