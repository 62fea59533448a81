"""Sliding-window spacetime decoding: O(window) memory for any round count.

The reference STUBBED this and never implemented it
(``/root/reference/python/qldpc/spacetime_code.py:95-96`` — "TODO: Sliding
window" — SURVEY.md §5 long-context note); its only streaming mode is the
window-of-1 single-shot decoder (``misc/_experiment.py:43-60``).  This module
implements the general overlapping-window scheme:

  * the differenced spacetime syndrome (``SpacetimeCode`` convention:
    ``sigma_u = H e_u + m_{u-1} + m_u``) is processed in windows of ``w``
    round-blocks with stride ``c <= w`` (commit region);
  * the WINDOW matrix is ``SpacetimeCode(H, w-1)`` plus an open-boundary
    measurement column block ``[0; I_r]`` for the last in-window round (its
    partner row lies outside the window);
  * after decoding a window, only the first ``c`` data blocks are committed
    into the running correction ``acc``; the window then advances by ``c``
    rounds.  Because the syndrome is differenced, only the FIRST in-window
    block depends on ``acc`` (``sigma_0 = s_t + H acc``) — interior blocks
    are unaffected, so the commit/rebase step is one sparse matvec;
  * the tail (once the transversal readout is reachable within ``w``
    rounds) decodes on the exact final ``SpacetimeCode`` with the perfect
    readout round, so a window >= total rounds reduces to the reference's
    full spacetime decode.

Every window reuses ONE jit-compiled batched decoder (fixed shapes), so the
stream decodes as ``ceil(rounds/c)`` fused device calls regardless of length
— the device analog of a real-time streaming decoder.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sparse

from .bp import BPDecoder
from .bposd import BPOSDDecoder
from .spacetime import SpacetimeCode

__all__ = ["SlidingWindowDecoder", "window_check_matrix"]


def window_check_matrix(check_matrix: sparse.spmatrix, window: int) -> sparse.spmatrix:
    """Open-boundary spacetime matrix for ``window`` noisy syndrome rounds.

    ``SpacetimeCode(H, window-1)`` covers rounds 0..window-1 with
    measurement columns between adjacent rounds; the appended ``[0; I_r]``
    block is the last round's own measurement error (whose second row block
    lives outside the window).
    """
    H = sparse.csr_matrix(check_matrix)
    r = H.shape[0]
    base = SpacetimeCode(H, window - 1).spacetime_check_matrix
    rows = base.shape[0]
    open_meas = sparse.vstack(
        [sparse.csr_matrix((rows - r, r), dtype=H.dtype),
         sparse.identity(r, dtype=H.dtype, format="csr")]
    )
    return sparse.hstack([base, open_meas]).tocsr()


@dataclass(eq=False)
class SlidingWindowDecoder:
    """Streaming multi-round decoder with bounded memory.

    ``decode_batch(history (S, rounds, r), readout (S, n)) -> (S, n)``
    final data correction, matching the contract of the full-matrix
    drivers.  ``window`` is the number of syndrome rounds decoded at once,
    ``commit`` the stride (defaults to ``window // 2``).
    """

    check_matrix: sparse.spmatrix
    data_prior: float
    meas_prior: float
    window: int = 4
    commit: Optional[int] = None
    bp_options: Dict = field(default_factory=dict)
    use_osd: bool = True

    def __post_init__(self):
        H = sparse.csr_matrix(self.check_matrix)
        self.check_matrix = H
        if self.commit is None:
            self.commit = max(1, self.window // 2)
        if not (1 <= self.commit <= self.window):
            raise ValueError("need 1 <= commit <= window")
        w = self.window
        r, n = H.shape
        self._r, self._n = r, n

        Hw = window_check_matrix(H, w)
        prior = np.concatenate(
            [np.full(w * n, self.data_prior), np.full(w * r, self.meas_prior)])
        factory = BPOSDDecoder if self.use_osd else BPDecoder
        self._win_dec = factory.from_check_matrix(
            Hw, channel_probs=prior, **self.bp_options)
        self._tail_cache: Dict[int, object] = {}

    def _tail_decoder(self, rounds: int):
        """Exact final-window decoder (perfect readout round) for ``rounds``
        remaining noisy rounds; cached per length."""
        if rounds not in self._tail_cache:
            st = SpacetimeCode(self.check_matrix, rounds)
            prior = np.concatenate(
                [np.full((rounds + 1) * self._n, self.data_prior),
                 np.full(rounds * self._r, self.meas_prior)])
            factory = BPOSDDecoder if self.use_osd else BPDecoder
            dec = factory.from_check_matrix(
                st.spacetime_check_matrix, channel_probs=prior,
                **self.bp_options)
            self._tail_cache[rounds] = (st, dec)
        return self._tail_cache[rounds]

    def _decode_window_batch(self, syndromes: np.ndarray) -> np.ndarray:
        out = self._win_dec.decode_batch(syndromes)
        if isinstance(out, tuple):  # plain BPDecoder returns (hard, post, ...)
            out = np.asarray(out[0])
        return np.asarray(out)

    def decode_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history: (S, rounds, r) raw per-round syndromes; readout: (S, n)."""
        history = np.asarray(history, dtype=np.int64)
        readout = np.asarray(readout, dtype=np.int64)
        S, rounds, r = history.shape
        n = self._n
        w, c = self.window, self.commit
        Hd = self.check_matrix.toarray().astype(np.int64)

        acc = np.zeros((S, n), dtype=np.int64)
        t = 0
        # stream interior windows while a full window of noisy rounds remains
        # BEFORE the readout can close the tail exactly
        while rounds - t > w:
            win = history[:, t:t + w, :].copy()
            win[:, 0, :] = (win[:, 0, :] + (acc @ Hd.T)) % 2
            # difference within the window (block 0 is already relative to
            # the committed state)
            win[:, 1:, :] = (win[:, 1:, :] + history[:, t:t + w - 1, :]) % 2
            correction = self._decode_window_batch(win.reshape(S, w * r))
            data = correction[:, : w * n].reshape(S, w, n)
            acc = (acc + data[:, :c, :].sum(axis=1)) % 2
            t += c

        # exact tail: remaining noisy rounds + perfect readout round.
        # Difference on RAW history/readout first (interior differences are
        # acc-free), then rebase ONLY block 0 onto the committed state
        tail_rounds = rounds - t
        st, dec = self._tail_decoder(tail_rounds)
        synd = st.syndrome_from_history_batch(history[:, t:, :], readout)
        synd[:, :r] = (synd[:, :r] + (acc @ Hd.T)) % 2
        correction = dec.decode_batch(synd)
        if isinstance(correction, tuple):
            correction = np.asarray(correction[0])
        final = st.final_correction(np.asarray(correction))
        return (final + acc) % 2
