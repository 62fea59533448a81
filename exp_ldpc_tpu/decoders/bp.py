"""Batched belief-propagation decoding on JAX/XLA.

Device-native replacement for the Cython ``ldpc`` package's ``bp_decoder``
(consumed by the reference at ``/root/reference/python/qldpc/misc/
_experiment.py:2,213-229``): flooding-schedule BP over a padded-ELL Tanner
graph with the SHOT DIMENSION fully vectorized — the reference decodes one
shot at a time in a Python loop (``misc/_experiment.py:199-209``, its
throughput bottleneck); here a whole Monte-Carlo batch decodes in one fused
XLA program.

Methods (matching the ldpc option surface, ``misc/_experiment.py:216-217``):
  * ``ps``  — product-sum (sum-product) in the numerically stable
    sign/phi-magnitude form, phi(x) = -log tanh(x/2);
  * ``ms``  — min-sum with scaling factor alpha; ``ms_scaling_factor = 0``
    selects the adaptive schedule alpha_t = 1 - 2^-t;
  * ``msl``/``psl`` — log-domain aliases of the same math.

Per-column channel priors are supported (data vs measurement-error columns
get different priors in every reference decode mode,
``misc/_experiment.py:33-35,74-76,106-108``).

Layout: SCATTER-FREE dual-layout messages (a scatter serializes updates to
one location, a static gather does not).  v2c messages live in the
check-major padded layout (C, Dc, S) (S = shots on the lane axis); the check
update is pure elementwise math in that layout; a single static gather
(``TannerELL.vm_from_cm``) re-arranges c2v into the variable-major layout
(V, Dv, S); the variable update is elementwise there; a second static gather
(``cm_from_vm``) returns to check-major.  Padded slots are routed to a
one-past-end pad row holding the neutral element (0 for sums, +BIG for
min/phi trees).  Per-shot early stopping is emulated by freezing each shot's
result at its first convergence; the iteration loop is a ``lax.while_loop``
that exits when every shot has converged (or max_iter).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .tanner import TannerELL

__all__ = ["BPDecoder", "bp_decode_batch", "priors_to_llr"]

_BIG = 1e30
_PHI_CLAMP_LO = 1e-7
_PHI_CLAMP_HI = 30.0


def priors_to_llr(priors: np.ndarray) -> np.ndarray:
    """Per-column error probabilities -> LLR log((1-p)/p)."""
    p = np.clip(np.asarray(priors, dtype=np.float64), 1e-12, 1 - 1e-12)
    return np.log((1 - p) / p).astype(np.float32)


def _phi(x):
    """phi(x) = -log(tanh(x/2)), self-inverse on (0, inf)."""
    x = jnp.clip(x, _PHI_CLAMP_LO, _PHI_CLAMP_HI)
    return -jnp.log(jnp.tanh(x * 0.5))


def _check_update_cm(v2c_cm, synd_sign, method: str, alpha):
    """Check-node update, elementwise in check-major layout.

    v2c_cm: (C, Dc, S) with padded slots = +BIG (sign +1, phi ~ 0, min-inert).
    Returns c2v in the same layout (padded slots hold garbage — never read:
    the vm gather only targets real slots or the pad row)."""
    one = v2c_cm.dtype.type(1)  # dtype-preserving (bf16 messages stay bf16)
    sign = jnp.where(v2c_cm < 0, -one, one)
    mag = jnp.abs(v2c_cm)
    total_sign = jnp.prod(sign, axis=1, keepdims=True) * synd_sign[:, None, :]
    ext_sign = total_sign * sign  # product of signs excluding self

    if method == "ps":
        ph = _phi(mag)
        total = jnp.sum(ph, axis=1, keepdims=True)
        ext = _phi(total - ph)
        return ext_sign * ext
    # min-sum
    min1 = jnp.min(mag, axis=1, keepdims=True)
    # second minimum: mask out one occurrence of the min
    is_min = (mag == min1) & (jnp.cumsum((mag == min1), axis=1) == 1)
    mag2 = jnp.where(is_min, _BIG, mag)
    min2 = jnp.min(mag2, axis=1, keepdims=True)
    ext = jnp.where(is_min, min2, min1)
    return ext_sign * ext * alpha


def _gather_flat(x_3d, idx, pad_value):
    """Gather rows of flattened (N*D, S) + pad row, by (N', D') index map."""
    nd, S = x_3d.shape[0] * x_3d.shape[1], x_3d.shape[2]
    flat = jnp.concatenate(
        [x_3d.reshape(nd, S), jnp.full((1, S), pad_value, x_3d.dtype)], axis=0
    )
    return flat[idx]  # (N', D', S)


def _var_update_vm(c2v_vm, prior_llr):
    """Variable-node update, elementwise in variable-major layout.

    c2v_vm: (V, Dv, S) with padded slots = 0.  Returns (v2c_vm, posterior)."""
    total = jnp.sum(c2v_vm, axis=1)  # (V, S)
    posterior = prior_llr[:, None] + total
    v2c_vm = posterior[:, None, :] - c2v_vm  # exclude self
    return v2c_vm, posterior


# dense one-hot operand bytes above which the matmul formulation is skipped
_DENSE_OPS_LIMIT = 128 * 2**20


def _dense_ops_bytes(tanner: TannerELL) -> int:
    return 2 * 4 * tanner.num_vars * tanner.num_checks * tanner.max_check_degree


@lru_cache(maxsize=32)
def _build_dense_ops(tanner: TannerELL):
    """0/1 message-routing operands for the matmul formulation.

    M (V, C*Dc): per-variable segment-sum of edge values (check-major flat);
    G (C*Dc, V): broadcast per-variable values back onto edges;
    Hd (C, V):   dense check matrix for the in-graph syndrome product;
    mask (C, Dc) bool.  One BP iteration becomes two matmuls plus
    elementwise math — no gathers or scatters at all.  Viable when the
    dense operands are small (`_dense_ops_bytes`); big codes take the
    gather path."""
    C, V, Dc = tanner.num_checks, tanner.num_vars, tanner.max_check_degree
    chk_vars = np.asarray(tanner.chk_vars)
    chk_mask = np.asarray(tanner.chk_mask)
    M = np.zeros((V, C * Dc), dtype=np.float32)
    flat = np.arange(C * Dc)
    v_of = chk_vars.reshape(-1)
    m_of = chk_mask.reshape(-1)
    M[v_of[m_of], flat[m_of]] = 1.0
    G = M.T.copy()
    Hd = np.zeros((C, V), dtype=np.float32)
    rows = np.repeat(np.arange(C), Dc)
    Hd[rows[m_of], v_of[m_of]] = 1.0
    return M, G, Hd, chk_mask  # numpy: traced-constant conversion at use site


@lru_cache(maxsize=32)
def dense_ops_device(tanner: TannerELL):
    """(M, G, Hd) as device arrays, for passing to ``_bp_core`` as ARGS.

    Multi-MB operands embedded as HLO constants slow compiles down and are
    baked into every executable; threading them as runtime arguments keeps
    the program small and lets repeated decodes reuse the same device
    buffers."""
    M, G, Hd, _ = _build_dense_ops(tanner)
    return jax.device_put(M), jax.device_put(G), jax.device_put(Hd)


def resolve_use_matmul(tanner: TannerELL, formulation: str) -> bool:
    if formulation == "auto":
        return _dense_ops_bytes(tanner) <= _DENSE_OPS_LIMIT
    return formulation == "matmul"


def _syndrome_of(hard, tanner: TannerELL):
    """H @ hard mod 2 as (C, S) int32, via the check-major var gather."""
    bits = hard[tanner.chk_vars]  # (C, Dc, S)
    bits = jnp.where(tanner.chk_mask[:, :, None], bits, 0).astype(jnp.int32)
    return jnp.sum(bits, axis=1) % 2


@partial(jax.jit, static_argnames=("tanner", "method", "max_iter", "early_stop", "formulation"))
def _bp_core(tanner: TannerELL, prior_llr, syndromes, method: str, max_iter: int, ms_scaling_factor, early_stop: bool = True, formulation: str = "auto", dense_ops=None):
    """syndromes: (C, S) uint8.  Returns (hard (V,S) uint8, posterior (V,S),
    converged (S,) bool, iters (S,) int32)."""
    C, S = syndromes.shape
    Dc = tanner.max_check_degree
    synd_sign = 1.0 - 2.0 * syndromes.astype(jnp.float32)  # (C, S)

    if formulation == "auto":
        use_matmul = _dense_ops_bytes(tanner) <= _DENSE_OPS_LIMIT
    else:
        use_matmul = formulation == "matmul"
    if use_matmul:
        if dense_ops is not None:
            # traced args: keeps multi-MB one-hot operands OUT of the HLO
            # constant pool (embedded constants bloat compiles)
            M, G, Hd = dense_ops
            mask = _build_dense_ops(tanner)[3]
        else:
            M, G, Hd, mask = _build_dense_ops(tanner)
        mask3 = mask[:, :, None]

    # init v2c with priors per edge, check-major; padded slots neutral (+BIG)
    edge_prior = prior_llr[np.asarray(tanner.chk_vars)]  # (C, Dc) static gather
    edge_prior = jnp.where(jnp.asarray(tanner.chk_mask), edge_prior, _BIG)
    v2c0 = jnp.broadcast_to(edge_prior[:, :, None], (C, Dc, S))

    adaptive = ms_scaling_factor == 0.0

    def step(it, v2c):
        """One flooding iteration: returns (v2c_new, posterior)."""
        alpha = jnp.where(adaptive, 1.0 - 2.0 ** (-(it + 1).astype(jnp.float32)), ms_scaling_factor)
        c2v_cm = _check_update_cm(v2c, synd_sign, method, alpha)
        if use_matmul:
            # masked c2v slots hold finite garbage; M/G zero-columns drop it.
            # HIGHEST: these dots carry LLRs, which TF32 would otherwise round
            totals = jnp.dot(M, c2v_cm.reshape(C * Dc, S),
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            posterior = prior_llr[:, None] + totals
            back = jnp.dot(G, posterior, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            v2c_new = jnp.where(mask3, back.reshape(C, Dc, S) - c2v_cm, _BIG)
        else:
            c2v_vm = _gather_flat(c2v_cm, tanner.vm_from_cm, 0.0)
            v2c_vm, posterior = _var_update_vm(c2v_vm, prior_llr)
            v2c_new = _gather_flat(v2c_vm, tanner.cm_from_vm, _BIG)
        return v2c_new, posterior

    def syndrome_ok(hard):
        """(S,) bool: H @ hard == syndrome (mod 2) per shot."""
        if use_matmul:
            # 0/1 x 0/1 parity counts: exact in TF32, default precision
            counts = jnp.dot(Hd, hard.astype(jnp.float32),
                             preferred_element_type=jnp.float32)
            par = counts - 2.0 * jnp.floor(counts * 0.5)
            return jnp.all((par > 0.5) == (syndromes > 0), axis=0)
        return jnp.all(_syndrome_of(hard, tanner) == syndromes, axis=0)

    if not early_stop:
        # fixed-iteration flooding: no per-iteration syndrome check at all
        posterior0 = jnp.broadcast_to(prior_llr[:, None], (tanner.num_vars, S))

        def fbody(it, carry):
            v2c, _post = carry
            return step(it, v2c)

        _v2c, posterior = jax.lax.fori_loop(0, max_iter, fbody, (v2c0, posterior0))
        hard = (posterior <= 0).astype(jnp.uint8)
        conv = syndrome_ok(hard)
        iters = jnp.full((S,), max_iter, dtype=jnp.int32)
        return hard, posterior, conv, iters

    hard0 = jnp.zeros((tanner.num_vars, S), dtype=jnp.uint8)
    posterior0 = jnp.broadcast_to(prior_llr[:, None], (tanner.num_vars, S))
    converged0 = jnp.zeros((S,), dtype=bool)
    iters0 = jnp.zeros((S,), dtype=jnp.int32)

    def cond(state):
        it, _v2c, _hard, _post, conv, _iters = state
        return (it < max_iter) & ~jnp.all(conv)

    def body(state):
        it, v2c, hard, post, conv, iters = state
        v2c_new, posterior = step(it, v2c)
        hard_new = (posterior <= 0).astype(jnp.uint8)
        ok = syndrome_ok(hard_new)  # (S,)
        # freeze each shot's outputs at its first convergence (ldpc semantics)
        hard = jnp.where(conv[None, :], hard, hard_new)
        post = jnp.where(conv[None, :], post, posterior)
        iters = jnp.where(conv, iters, it + 1)
        conv = conv | ok
        return (it + 1, v2c_new, hard, post, conv, iters)

    state = (jnp.int32(0), v2c0, hard0, posterior0, converged0, iters0)
    _, _, hard, post, conv, iters = jax.lax.while_loop(cond, body, state)
    return hard, post, conv, iters


@dataclass
class BPDecoder:
    """Batched BP decoder for a fixed check matrix and channel prior.

    ``decode_batch`` takes (S, C) syndromes and returns (S, V) hard
    decisions, (S, V) posterior LLRs, (S,) convergence flags, (S,) iteration
    counts.
    """

    tanner: TannerELL
    prior_llr: np.ndarray
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0
    early_stop: bool = True
    # "auto": one-hot matmul message routing for small codes, gathers for large;
    # "gather"/"matmul" pin the formulation (hard decisions can differ on
    # non-converged shots between formulations — f32 ordering)
    formulation: str = "auto"

    def __post_init__(self):
        method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}.get(self.method)
        if method is None:
            raise ValueError(f"unknown bp method {self.method!r}")
        object.__setattr__(self, "method", method)
        if self.max_iter <= 0:
            object.__setattr__(self, "max_iter", self.tanner.num_vars)

    @classmethod
    def from_check_matrix(
        cls,
        H,
        *,
        error_rate: Optional[float] = None,
        channel_probs: Optional[np.ndarray] = None,
        max_iter: int = 0,
        bp_method: str = "ps",
        ms_scaling_factor: float = 0.0,
        early_stop: bool = True,
        formulation: str = "auto",
        **_ignored,
    ) -> "BPDecoder":
        """Constructor mirroring the ldpc option surface
        (``misc/_experiment.py:213-229``)."""
        tanner = TannerELL.from_check_matrix(H)
        if channel_probs is not None:
            prior = np.asarray(channel_probs, dtype=np.float64)
        elif error_rate is not None:
            prior = np.full(tanner.num_vars, error_rate, dtype=np.float64)
        else:
            raise ValueError("must supply error_rate or channel_probs")
        return cls(
            tanner=tanner,
            prior_llr=priors_to_llr(prior),
            method=bp_method,
            max_iter=max_iter,
            ms_scaling_factor=float(ms_scaling_factor),
            early_stop=early_stop,
            formulation=formulation,
        )

    def decode_batch(self, syndromes: np.ndarray):
        syndromes = jnp.asarray(syndromes, dtype=jnp.uint8).T  # (C, S)
        hard, post, conv, iters = _bp_core(
            self.tanner,
            jnp.asarray(self.prior_llr),
            syndromes,
            self.method,
            self.max_iter,
            jnp.float32(self.ms_scaling_factor),
            self.early_stop,
            self.formulation,
            dense_ops_device(self.tanner)
            if resolve_use_matmul(self.tanner, self.formulation) else None,
        )
        return hard.T, post.T, conv, iters

    def decode(self, syndrome: np.ndarray):
        """Single-shot convenience wrapper (oracle/compat path)."""
        hard, _post, _conv, _it = self.decode_batch(np.asarray(syndrome)[None, :])
        return np.asarray(hard[0])


def bp_decode_batch(H, syndromes, **kw):
    return BPDecoder.from_check_matrix(H, **kw).decode_batch(syndromes)
