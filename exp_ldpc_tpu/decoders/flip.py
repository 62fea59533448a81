"""Batched flip and small-set-flip decoders on JAX/XLA.

Completes SURVEY.md §7 layer 6(c) ("flip / small-set-flip post-processing").
The reference delegates all decoding to the ``ldpc`` package (which offers
BP/OSD only); flip-family decoders extend the decoder inventory beyond
reference parity:

  * ``FlipDecoder`` — Gallager/Sipser–Spielman parallel bit-flip for
    CLASSICAL codes: flip every bit for which a strict majority of its
    checks is unsatisfied.  One iteration is two matmuls (unsat counts,
    syndrome refresh) — no gathers, no scatters, shots fully vectorized.
  * ``SmallSetFlipDecoder`` — Leverrier–Tillich–Zémor small-set-flip for
    CSS quantum codes (arXiv:1504.00822 algorithm; the reference has no
    equivalent): greedily flip the qubit subset F of some opposite-sector
    stabilizer generator's support maximizing (syndrome-weight decrease)/|F|.
    All (generator, subset) gains for a whole shot batch evaluate as ONE
    batched einsum over a precomputed subset→syndrome-change table; the
    chosen flip applies scatter-free via one-hot matmuls.

Both decoders follow the repo conventions of ``decoders/bp.py``: static
shapes, per-shot freezing inside a ``lax.while_loop``, device math in f32
(all values are small exact integers, so f32 is exact).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

__all__ = [
    "FlipDecoder",
    "SmallSetFlipDecoder",
    "flip_decode_numpy",
    "ssf_decode_numpy",
]

_NEG = np.float32(-1e30)


def _dense01(H) -> np.ndarray:
    H = sparse.csr_matrix(H)
    return (H.toarray() % 2).astype(np.float32)


# --------------------------------------------------------------------------
# parallel bit-flip (classical)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("max_iter",))
def _flip_core(Hd, deg, syndromes, max_iter: int):
    """Hd (C, V) 0/1 f32; deg (V,) f32; syndromes (C, S) uint8.

    Returns (hard (V, S) uint8, converged (S,), iters (S,))."""
    C, S = syndromes.shape
    V = Hd.shape[1]
    s0 = syndromes.astype(jnp.float32)
    e0 = jnp.zeros((V, S), jnp.float32)
    conv0 = jnp.all(s0 == 0, axis=0)
    iters0 = jnp.zeros((S,), jnp.int32)

    def cond(state):
        it, _e, _s, done = state[0], state[1], state[2], state[3]
        return (it < max_iter) & ~jnp.all(done)

    def body(state):
        it, e, s, done, conv, iters = state
        # 0/1 x 0/1 counts: exact in TF32, default precision
        unsat = jnp.dot(Hd.T, s, preferred_element_type=jnp.float32)  # (V, S)
        flip = (2.0 * unsat > deg[:, None]).astype(jnp.float32)
        active = ~done
        flip = flip * active[None, :].astype(jnp.float32)
        e = jnp.mod(e + flip, 2.0)
        ds = jnp.dot(Hd, flip, preferred_element_type=jnp.float32)
        s = jnp.mod(s + ds, 2.0)
        ok = jnp.all(s == 0, axis=0)
        stuck = jnp.all(flip == 0, axis=0) & active  # majority rule fired nothing
        iters = jnp.where(active, it + 1, iters)
        conv = conv | (ok & active)
        done = done | ok | stuck
        return (it + 1, e, s, done, conv, iters)

    state = (jnp.int32(0), e0, s0, conv0, conv0, iters0)
    _, e, _s, _done, conv, iters = jax.lax.while_loop(cond, body, state)
    return e.astype(jnp.uint8), conv, iters


@dataclass
class FlipDecoder:
    """Parallel bit-flip decoder for a fixed classical check matrix.

    ``decode_batch`` takes (S, C) syndromes and returns ((S, V) hard
    decisions, (S,) converged-to-zero-syndrome flags, (S,) iterations)."""

    Hd: np.ndarray  # dense 0/1 f32 (C, V)
    max_iter: int = 0

    def __post_init__(self):
        if self.max_iter <= 0:
            object.__setattr__(self, "max_iter", self.Hd.shape[1])

    @classmethod
    def from_check_matrix(cls, H, *, max_iter: int = 0) -> "FlipDecoder":
        return cls(Hd=_dense01(H), max_iter=max_iter)

    def decode_batch(self, syndromes: np.ndarray):
        syndromes = jnp.asarray(syndromes, dtype=jnp.uint8).T  # (C, S)
        deg = jnp.asarray(self.Hd.sum(axis=0))
        hard, conv, iters = _flip_core(
            jnp.asarray(self.Hd), deg, syndromes, self.max_iter
        )
        return np.asarray(hard).T, np.asarray(conv), np.asarray(iters)


def flip_decode_numpy(H, syndromes, max_iter: int = 0):
    """CPU oracle with the identical parallel-majority rule (bit-exact)."""
    Hd = _dense01(H)
    C, V = Hd.shape
    if max_iter <= 0:
        max_iter = V
    deg = Hd.sum(axis=0)
    syndromes = np.asarray(syndromes, dtype=np.uint8)
    S = syndromes.shape[0]
    e = np.zeros((S, V), np.uint8)
    s = syndromes.astype(np.float32).copy()
    conv = np.all(s == 0, axis=1)
    done = conv.copy()
    iters = np.zeros(S, np.int32)
    for it in range(max_iter):
        if done.all():
            break
        unsat = s @ Hd  # (S, V)
        flip = (2.0 * unsat > deg[None, :]) & ~done[:, None]
        e ^= flip.astype(np.uint8)
        s = (s + flip.astype(np.float32) @ Hd.T) % 2
        ok = np.all(s == 0, axis=1)
        stuck = ~flip.any(axis=1) & ~done
        iters[~done] = it + 1
        conv |= ok & ~done
        done |= ok | stuck
    return e, conv, iters


# --------------------------------------------------------------------------
# small-set-flip (CSS)
# --------------------------------------------------------------------------


def _ssf_tables(H, G, max_subset_weight: int):
    """Host precompute of the per-generator subset search tables.

    H (C, V): the syndrome check matrix; G (R, V): opposite-sector stabilizer
    generators whose supports the search flips within.

    Returns (gen_qubits (R, W) int32 pad=V, chk_ids (R, L) int32 pad=C,
    delta (R, K, L) f32 with K=2^W subset syndrome-changes, sizes (K,) f32
    subset cardinalities, Wbits (K, W) f32 subset bit patterns)."""
    Hd = _dense01(H).astype(np.uint8)
    Gd = _dense01(G).astype(np.uint8)
    C, V = Hd.shape
    R = Gd.shape[0]
    supports = [np.nonzero(Gd[r])[0] for r in range(R)]
    W = max((len(s) for s in supports), default=0)
    if W > max_subset_weight:
        raise ValueError(
            f"generator weight {W} exceeds max_subset_weight={max_subset_weight} "
            f"(2^{W} subsets per generator)"
        )
    K = 1 << W
    # local H-checks touched by each generator's support
    locals_ = [np.nonzero(Hd[:, s].any(axis=1))[0] for s in supports]
    L = max((len(c) for c in locals_), default=1)

    gen_qubits = np.full((R, W), V, np.int32)
    chk_ids = np.full((R, L), C, np.int32)
    Hloc = np.zeros((R, L, W), np.uint8)
    for r in range(R):
        q = supports[r]
        c = locals_[r]
        gen_qubits[r, : len(q)] = q
        chk_ids[r, : len(c)] = c
        Hloc[r, : len(c), : len(q)] = Hd[np.ix_(c, q)]

    bits = ((np.arange(K)[:, None] >> np.arange(W)[None, :]) & 1).astype(np.uint8)
    # delta[r, k, l] = parity of H restricted rows over subset k
    delta = np.einsum("kw,rlw->rkl", bits, Hloc) % 2
    sizes = bits.sum(axis=1).astype(np.float32)
    return (
        gen_qubits,
        chk_ids,
        delta.astype(np.float32),
        sizes,
        bits.astype(np.float32),
    )


@partial(jax.jit, static_argnames=("num_vars", "max_iter"))
def _ssf_core(gen_qubits, chk_ids, delta, sizes, bits, syndromes,
              num_vars: int, max_iter: int):
    """syndromes (C, S) uint8 -> (hard (V, S) uint8, conv (S,), iters (S,)).

    Each iteration applies, per shot, the single (generator, subset) flip
    with the best positive (syndrome-weight decrease)/|subset| ratio."""
    C, S = syndromes.shape
    R, K, L = delta.shape
    V = num_vars
    inv_sizes = jnp.where(sizes > 0, 1.0 / jnp.maximum(sizes, 1.0), _NEG)

    s0 = syndromes.astype(jnp.float32)
    e0 = jnp.zeros((V, S), jnp.float32)
    conv0 = jnp.all(s0 == 0, axis=0)
    iters0 = jnp.zeros((S,), jnp.int32)

    s_pad_row = jnp.zeros((1, S), jnp.float32)

    def cond(state):
        it, _e, _s, done = state[0], state[1], state[2], state[3]
        return (it < max_iter) & ~jnp.all(done)

    def body(state):
        it, e, s, done, conv, iters = state
        s_pad = jnp.concatenate([s, s_pad_row], axis=0)  # pad check -> 0
        s_loc = s_pad[chk_ids]  # (R, L, S) static gather
        # decrease[r, k, s] = sum_l delta * (2 s_loc - 1)
        decrease = jnp.einsum(
            "rkl,rls->rks", delta, 2.0 * s_loc - 1.0,
            preferred_element_type=jnp.float32,
        )
        ratio = decrease * inv_sizes[None, :, None]  # empty subset -> -inf
        flat = ratio.reshape(R * K, S)
        idx = jnp.argmax(flat, axis=0)  # (S,) first max (oracle-matching)
        best = jnp.take_along_axis(flat, idx[None, :], axis=0)[0]
        active = (best > 0) & ~done

        gen = idx // K
        sub = idx % K
        act_f = active.astype(jnp.float32)
        # error update: one-hot of the chosen subset's qubits (pad id V -> 0 row)
        qids = gen_qubits[gen]  # (S, W)
        qbits = bits[sub]  # (S, W)
        e_delta = jnp.einsum(
            "swv,sw->vs", jax.nn.one_hot(qids, V, dtype=jnp.float32), qbits,
            preferred_element_type=jnp.float32,
        )
        e = jnp.mod(e + e_delta * act_f[None, :], 2.0)
        # syndrome update: chosen subset's delta onto its local checks
        cids = chk_ids[gen]  # (S, L)
        d = delta[gen, sub]  # (S, L)
        s_delta = jnp.einsum(
            "slc,sl->cs", jax.nn.one_hot(cids, C, dtype=jnp.float32), d,
            preferred_element_type=jnp.float32,
        )
        s = jnp.mod(s + s_delta * act_f[None, :], 2.0)

        ok = jnp.all(s == 0, axis=0)
        iters = jnp.where(active, it + 1, iters)
        conv = conv | (ok & active)
        done = done | ok | ~active
        return (it + 1, e, s, done, conv, iters)

    state = (jnp.int32(0), e0, s0, conv0, conv0, iters0)
    _, e, _s, _done, conv, iters = jax.lax.while_loop(cond, body, state)
    return e.astype(jnp.uint8), conv, iters


@dataclass
class SmallSetFlipDecoder:
    """Small-set-flip decoder for one CSS sector.

    ``H`` is the check matrix producing the syndrome (e.g. ``checks.z`` for
    X errors) and ``generators`` the OPPOSITE sector's stabilizer matrix
    (``checks.x``), whose row supports bound the flip subsets
    (arXiv:1504.00822; designed for expander HGP codes).

    ``decode_batch`` takes (S, C) syndromes and returns ((S, V) hard
    decisions, (S,) converged flags, (S,) flips applied)."""

    tables: tuple
    num_vars: int
    max_iter: int

    @classmethod
    def from_css(cls, H, generators, *, max_iter: int = 0,
                 max_subset_weight: int = 14) -> "SmallSetFlipDecoder":
        H = sparse.csr_matrix(H)
        V = H.shape[1]
        if sparse.csr_matrix(generators).shape[1] != V:
            raise ValueError("H and generators must share the qubit count")
        tables = _ssf_tables(H, generators, max_subset_weight)
        if max_iter <= 0:
            max_iter = V
        return cls(tables=tables, num_vars=V, max_iter=max_iter)

    def decode_batch(self, syndromes: np.ndarray):
        syndromes = jnp.asarray(syndromes, dtype=jnp.uint8).T  # (C, S)
        gq, ci, delta, sizes, bits = (jnp.asarray(t) for t in self.tables)
        hard, conv, iters = _ssf_core(
            gq, ci, delta, sizes, bits, syndromes, self.num_vars, self.max_iter
        )
        return np.asarray(hard).T, np.asarray(conv), np.asarray(iters)


def ssf_decode_numpy(H, generators, syndromes, max_iter: int = 0,
                     max_subset_weight: int = 14):
    """CPU oracle applying the identical greedy rule, subset enumeration
    order, and first-max tie-breaking (bit-exact vs the device kernel)."""
    gen_qubits, chk_ids, delta, sizes, bits = _ssf_tables(
        H, generators, max_subset_weight
    )
    Hd = _dense01(H)
    C, V = Hd.shape
    R, K, L = delta.shape
    if max_iter <= 0:
        max_iter = V
    inv_sizes = np.where(sizes > 0, 1.0 / np.maximum(sizes, 1.0), _NEG)

    syndromes = np.asarray(syndromes, dtype=np.uint8)
    S = syndromes.shape[0]
    e = np.zeros((S, V), np.uint8)
    s = syndromes.astype(np.float32).copy()
    conv = np.all(s == 0, axis=1)
    done = conv.copy()
    iters = np.zeros(S, np.int32)
    s_pad = np.zeros((S, C + 1), np.float32)
    for it in range(max_iter):
        if done.all():
            break
        s_pad[:, :C] = s
        s_loc = s_pad[:, chk_ids]  # (S, R, L)
        decrease = np.einsum("rkl,srl->srk", delta, 2.0 * s_loc - 1.0).astype(np.float32)
        ratio = (decrease * inv_sizes[None, None, :]).reshape(S, R * K)
        idx = np.argmax(ratio, axis=1)
        best = ratio[np.arange(S), idx]
        active = (best > 0) & ~done
        for i in np.nonzero(active)[0]:
            r, k = divmod(int(idx[i]), K)
            q = gen_qubits[r]
            b = bits[k].astype(np.uint8)
            real = q < V
            e[i, q[real]] ^= b[real]
            c = chk_ids[r]
            d = delta[r, k].astype(np.uint8)
            realc = c < C
            s[i, c[realc]] = (s[i, c[realc]] + d[realc]) % 2
            iters[i] = it + 1
        ok = np.all(s == 0, axis=1)
        conv |= ok & active
        done |= ok | ~active
    return e, conv, iters
