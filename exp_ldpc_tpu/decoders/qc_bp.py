"""Quasi-cyclic structured BP: circulant-block routing as cyclic rolls.

The production-scale code families are quasi-cyclic: bivariate bicycle
codes (``codes/bivariate_bicycle.py``), Panteleev–Kalachev QC lifted
products (``codes/qc_lifted.py``, reference
``/root/reference/python/qldpc/qc_lifted_product_code.py``), and cyclic
lifted products (abelian ``Zqm`` groups in ``codes/lifted.py``).  Their
check matrices are grids of circulant blocks — every block is a sum of
shifted identities x^s — so message routing between the check-major and
variable-major layouts is a CYCLIC SHIFT: a contiguous rotation, no
gathers, no one-hot matmuls.

The generic formulations in :mod:`.bp` pay heavily here: the one-hot
routing does O(n·C·Dc) FLOPs per shot-iteration against the O(E) real work,
and the static-gather path moves every message through an index table.  This kernel stores one (l1·l2, S) message plane per circulant
MONOMIAL and runs the identical flooding math (same
:func:`~exp_ldpc_tpu.decoders.bp._check_update_cm` check kernel, same
per-shot early-stop freezing) with rolls as the only data movement —
O(E) FLOPs, VPU-bound.

Block structure is DETECTED from the dense matrix
(:meth:`QCStructure.from_check_matrix`): the caller supplies the cyclic
factor sizes ``dims`` (e.g. ``(31,)`` for one circulant factor, ``(12, 6)``
for a bivariate Z_12 x Z_6 code) and every (l1·l2)-sized block is validated
to be an exact sum of shifted identities — non-QC matrices raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

from .bp import _BIG, _check_update_cm, priors_to_llr

__all__ = ["QCStructure", "QCBPDecoder"]


@dataclass(frozen=True, eq=False)  # identity hash: jit static arg
class QCStructure:
    """Circulant-block structure of a check matrix.

    ``monomials[k] = (check_block, var_block, shifts)`` means block
    (check_block, var_block) contains the monomial with per-factor shifts
    ``shifts``: check row r (multi-index over ``dims``) touches var column
    r + shifts (componentwise mod dims)."""

    dims: Tuple[int, ...]
    num_check_blocks: int
    num_var_blocks: int
    monomials: Tuple[Tuple[int, int, Tuple[int, ...]], ...]

    @property
    def block_size(self) -> int:
        return int(np.prod(self.dims))

    @property
    def num_checks(self) -> int:
        return self.num_check_blocks * self.block_size

    @property
    def num_vars(self) -> int:
        return self.num_var_blocks * self.block_size

    @classmethod
    def from_check_matrix(cls, H, dims) -> "QCStructure":
        dims = tuple(int(d) for d in dims)
        L = int(np.prod(dims))
        H = sparse.csr_matrix(H)
        Hd = (H.toarray() % 2).astype(np.uint8)
        r, n = Hd.shape
        if r % L or n % L:
            raise ValueError(
                f"shape {Hd.shape} not divisible by block size {L} (dims={dims})"
            )
        mb, nb = r // L, n // L
        monomials = []
        for i in range(mb):
            for j in range(nb):
                blk = Hd[i * L:(i + 1) * L, j * L:(j + 1) * L]
                cols = np.nonzero(blk[0])[0]
                expect = np.zeros((L, L), np.uint8)
                shifts = []
                for c in cols:
                    s = np.unravel_index(int(c), dims)
                    shifts.append(tuple(int(x) for x in s))
                    # monomial: row multi-index r -> column r + s (mod dims)
                    m = np.eye(dims[0], dtype=np.uint8)
                    m = np.roll(m, s[0], axis=1)
                    for ax in range(1, len(dims)):
                        e = np.roll(np.eye(dims[ax], dtype=np.uint8), s[ax], axis=1)
                        m = np.kron(m, e)
                    expect ^= m
                if not np.array_equal(blk, expect):
                    raise ValueError(
                        f"block ({i},{j}) is not a sum of shifted identities "
                        f"over dims={dims}"
                    )
                monomials += [(i, j, s) for s in shifts]
        return cls(
            dims=dims,
            num_check_blocks=mb,
            num_var_blocks=nb,
            monomials=tuple(monomials),
        )


def _roll(x, shifts, sign):
    """Roll the per-factor axes (1..len(dims)) of (K?, *dims, S) by
    sign*shifts."""
    axes = tuple(range(1, 1 + len(shifts)))
    return jnp.roll(x, tuple(sign * s for s in shifts), axes)


@partial(jax.jit, static_argnames=("struct", "method", "max_iter", "early_stop"))
def _qc_bp_core(struct: QCStructure, prior_llr, syndromes, method: str,
                max_iter: int, ms_scaling_factor, early_stop: bool = True):
    """syndromes (C, S) uint8 -> (hard (V,S) uint8, posterior (V,S) f32,
    converged (S,) bool, iters (S,) int32) — the `_bp_core` contract."""
    dims = struct.dims
    L = struct.block_size
    mb, nb = struct.num_check_blocks, struct.num_var_blocks
    mons = struct.monomials
    K = len(mons)
    by_check = [[k for k, m in enumerate(mons) if m[0] == i] for i in range(mb)]
    by_var = [[k for k, m in enumerate(mons) if m[1] == j] for j in range(nb)]
    Dc = max(len(ks) for ks in by_check)

    C, S = syndromes.shape
    synd_sign = 1.0 - 2.0 * syndromes.astype(jnp.float32)  # (C, S)
    synd_i32 = syndromes.astype(jnp.int32).reshape((mb,) + dims + (S,))

    prior_b = prior_llr.reshape((nb,) + dims)  # (nb, *dims)

    # one message plane per monomial, CHECK-major: plane_k[r] lives on edge
    # (check (i, r), var (j, r + s)).  init = prior at the edge's variable.
    v2c0 = jnp.stack(
        [
            jnp.broadcast_to(
                _roll(prior_b[m[1]][None], m[2], -1)[0][..., None],
                dims + (S,),
            )
            for m in mons
        ]
    )  # (K, *dims, S)

    adaptive = ms_scaling_factor == 0.0
    pad = jnp.full(dims + (S,), _BIG, jnp.float32)

    def step(it, v2c):
        alpha = jnp.where(
            adaptive, 1.0 - 2.0 ** (-(it + 1).astype(jnp.float32)), ms_scaling_factor
        )
        # check update: group planes per check block, pad to Dc, reuse the
        # generic check kernel on ((mb*L), Dc, S)
        stacked = jnp.stack(
            [
                jnp.stack([v2c[k] for k in ks] + [pad] * (Dc - len(ks)))
                for ks in by_check
            ]
        )  # (mb, Dc, *dims, S)
        cm = jnp.moveaxis(stacked, 1, -2).reshape(mb * L, Dc, S)
        c2v_cm = _check_update_cm(cm, synd_sign, method, alpha)
        c2v_st = jnp.moveaxis(
            c2v_cm.reshape((mb,) + dims + (Dc, S)), -2, 1
        )  # (mb, Dc, *dims, S)
        c2v = [None] * K
        for i, ks in enumerate(by_check):
            for slot, k in enumerate(ks):
                c2v[k] = c2v_st[i, slot]

        # variable update: roll each plane into var alignment, segment-sum
        posts = []
        for j, ks in enumerate(by_var):
            tot = jnp.broadcast_to(prior_b[j][..., None], dims + (S,))
            for k in ks:
                tot = tot + _roll(c2v[k][None], mons[k][2], +1)[0]
            posts.append(tot)
        posterior = jnp.stack(posts)  # (nb, *dims, S)
        v2c_new = jnp.stack(
            [
                _roll(posterior[m[1]][None], m[2], -1)[0] - c2v[k]
                for k, m in enumerate(mons)
            ]
        )
        return v2c_new, posterior

    def syndrome_ok(hard_b):
        """hard_b (nb, *dims, S) uint8 -> (S,) parity match."""
        par = jnp.zeros((mb,) + dims + (S,), jnp.int32)
        for k, m in enumerate(mons):
            par = par.at[m[0]].add(_roll(hard_b[m[1]][None], m[2], -1)[0])
        return jnp.all(par % 2 == synd_i32, axis=tuple(range(1 + len(dims))))

    def flatten(posterior):
        post = posterior.reshape(nb * L, S)
        return (post <= 0).astype(jnp.uint8), post

    posterior0 = jnp.broadcast_to(
        prior_b[..., None], (nb,) + dims + (S,)
    )

    if not early_stop:
        def fbody(it, carry):
            v2c, _post = carry
            return step(it, v2c)

        _v2c, posterior = jax.lax.fori_loop(0, max_iter, fbody, (v2c0, posterior0))
        hard, post = flatten(posterior)
        conv = syndrome_ok((posterior <= 0).astype(jnp.uint8))
        iters = jnp.full((S,), max_iter, jnp.int32)
        return hard, post, conv, iters

    hard0, post0 = flatten(posterior0)
    converged0 = jnp.zeros((S,), bool)
    iters0 = jnp.zeros((S,), jnp.int32)

    def cond(state):
        it, _v2c, _hard, _post, conv, _iters = state
        return (it < max_iter) & ~jnp.all(conv)

    def body(state):
        it, v2c, hard, post, conv, iters = state
        v2c_new, posterior = step(it, v2c)
        hard_new, post_new = flatten(posterior)
        ok = syndrome_ok((posterior <= 0).astype(jnp.uint8))
        hard = jnp.where(conv[None, :], hard, hard_new)
        post = jnp.where(conv[None, :], post, post_new)
        iters = jnp.where(conv, iters, it + 1)
        conv = conv | ok
        return (it + 1, v2c_new, hard, post, conv, iters)

    state = (jnp.int32(0), v2c0, hard0, post0, converged0, iters0)
    _, _, hard, post, conv, iters = jax.lax.while_loop(cond, body, state)
    return hard, post, conv, iters


@dataclass
class QCBPDecoder:
    """Batched BP for quasi-cyclic codes, API-compatible with
    :class:`~exp_ldpc_tpu.decoders.bp.BPDecoder` (drops into
    :class:`~exp_ldpc_tpu.decoders.bposd.BPOSDDecoder` as the ``bp``
    stage).

    ``check_perm``/``var_perm`` (new->old) bring a matrix that is
    block-circulant only up to row/column order into QC order (e.g. abelian
    lifted products, whose group index sits mid-radix —
    ``codes/lifted.py:_abelian_qc_layout``); syndromes are permuted in and
    all outputs are returned in the ORIGINAL column order."""

    struct: QCStructure
    prior_llr: np.ndarray
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0
    early_stop: bool = True
    check_perm: Optional[np.ndarray] = None
    inv_var_perm: Optional[np.ndarray] = None  # old -> new

    def __post_init__(self):
        method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}.get(self.method)
        if method is None:
            raise ValueError(f"unknown bp method {self.method!r}")
        object.__setattr__(self, "method", method)
        if self.max_iter <= 0:
            object.__setattr__(self, "max_iter", self.struct.num_vars)

    @classmethod
    def from_check_matrix(
        cls,
        H,
        dims,
        *,
        error_rate: Optional[float] = None,
        channel_probs: Optional[np.ndarray] = None,
        max_iter: int = 0,
        bp_method: str = "ps",
        ms_scaling_factor: float = 0.0,
        early_stop: bool = True,
        check_perm: Optional[np.ndarray] = None,
        var_perm: Optional[np.ndarray] = None,
        **_ignored,
    ) -> "QCBPDecoder":
        H = sparse.csr_matrix(H)
        if check_perm is not None:
            check_perm = np.asarray(check_perm, dtype=np.int64)
            H = H[check_perm]
        if var_perm is not None:
            var_perm = np.asarray(var_perm, dtype=np.int64)
            H = H[:, var_perm]
        struct = QCStructure.from_check_matrix(H, dims)
        if channel_probs is not None:
            prior = np.asarray(channel_probs, dtype=np.float64)
        elif error_rate is not None:
            prior = np.full(struct.num_vars, error_rate, dtype=np.float64)
        else:
            raise ValueError("must supply error_rate or channel_probs")
        if prior.shape[0] != struct.num_vars:
            raise ValueError(f"channel_probs must have {struct.num_vars} entries")
        if var_perm is not None:
            prior = prior[var_perm]
        inv_var_perm = None
        if var_perm is not None:
            inv_var_perm = np.empty_like(var_perm)
            inv_var_perm[var_perm] = np.arange(var_perm.shape[0])
        return cls(
            struct=struct,
            prior_llr=priors_to_llr(prior),
            method=bp_method,
            max_iter=max_iter,
            ms_scaling_factor=float(ms_scaling_factor),
            early_stop=early_stop,
            check_perm=check_perm,
            inv_var_perm=inv_var_perm,
        )

    def decode_batch(self, syndromes: np.ndarray):
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        if self.check_perm is not None:
            syndromes = syndromes[:, self.check_perm]
        hard, post, conv, iters = _qc_bp_core(
            self.struct,
            jnp.asarray(self.prior_llr),
            jnp.asarray(syndromes).T,
            self.method,
            self.max_iter,
            jnp.float32(self.ms_scaling_factor),
            self.early_stop,
        )
        hard, post = hard.T, post.T
        if self.inv_var_perm is not None:
            hard = jnp.asarray(hard)[:, self.inv_var_perm]
            post = jnp.asarray(post)[:, self.inv_var_perm]
        return hard, post, conv, iters

    def decode(self, syndrome: np.ndarray):
        hard, _post, _conv, _it = self.decode_batch(np.asarray(syndrome)[None, :])
        return np.asarray(hard[0])
