"""Decoder-formulation and platform selection.

The reference delegates every code to one Cython BP implementation
(``/root/reference/python/qldpc/misc/_experiment.py:51-59``); here the
formulation depends on size and structure: the dense one-hot matmul
formulation for small codes, the quasi-cyclic roll kernel (:mod:`.qc_bp`)
for large block-circulant codes, and the static-gather formulation of
:class:`~exp_ldpc_tpu.decoders.bp.BPDecoder` for everything else.  This
module is the one place those decisions live, and :func:`bp_backend` is the
one place the platform is decided.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy import sparse

from ..utils.compile_cache import enable_compilation_cache
from .bp import BPDecoder, _dense_ops_bytes
from .qc_bp import QCBPDecoder
from .tanner import TannerELL

__all__ = ["bp_backend", "make_bp_decoder", "make_spacetime_bp_decoder",
           "qc_kwargs_for_code", "qc_kwargs_single_shot"]

# above this monomial count the unrolled roll kernel's compile time and HLO
# size are not worth it; fall back to the generic formulations
_QC_MAX_MONOMIALS = 256

# below this dense-operand size the generic one-hot matmul formulation is
# kept over the roll kernel.  The crossover was fitted on the previous
# accelerator and is not measured on the GPU.
_QC_PREFER_DENSE_OPS_LIMIT = 4 * 2**20

# platforms the device formulations are built for
_BACKENDS = {"cpu": "xla", "gpu": "triton"}


def bp_backend(devices=None) -> str:
    """The BP backend for the platform of ``devices`` (default: all of
    ``jax.devices()``): ``"xla"`` or ``"triton"``.

    On the CPU every decode runs through XLA (what the tests use).  On the
    GPU the fixed-iteration spacetime-BP stage of the pipeline runs the
    Pallas-Triton kernel (``decoders/spacetime_bp_triton.py``), which beat
    the XLA core end to end on an H100 (``PERF.md``), for base codes it
    fits; everything else runs through XLA.  Any other platform raises
    rather than running formulations nobody has checked there; a kernel
    that fails to compile raises too, it does not fall back."""
    import jax

    devices = jax.devices() if devices is None else list(devices)
    platforms = {d.platform for d in devices}
    if len(platforms) != 1:
        raise ValueError(f"mixed device platforms {sorted(platforms)}")
    (platform,) = platforms
    if platform not in _BACKENDS:
        raise ValueError(
            f"no BP backend for platform {platform!r}; "
            f"supported: {sorted(_BACKENDS)}")
    return _BACKENDS[platform]


def make_bp_decoder(
    H,
    *,
    qc_dims=None,
    qc_check_perm: Optional[np.ndarray] = None,
    qc_var_perm: Optional[np.ndarray] = None,
    **opts,
):
    """BP decoder with automatic QC routing.

    With ``qc_dims`` given (block-circulant layout, optionally up to the
    new->old ``qc_check_perm``/``qc_var_perm``), the roll-based
    :class:`QCBPDecoder` when the monomial count is in the kernel's sweet
    spot and the dense operands are large; else the generic
    :class:`BPDecoder` (one-hot matmul or gather formulation, by operand
    size).  Both expose the same ``decode_batch`` contract."""
    bp_backend()
    enable_compilation_cache()
    H = sparse.csr_matrix(H)
    if qc_dims is not None:
        tanner = TannerELL.from_check_matrix(H)
        L = int(np.prod(qc_dims))
        num_monomials = H.nnz // L
        if (num_monomials <= _QC_MAX_MONOMIALS
                and _dense_ops_bytes(tanner) > _QC_PREFER_DENSE_OPS_LIMIT):
            return QCBPDecoder.from_check_matrix(
                H, qc_dims, check_perm=qc_check_perm, var_perm=qc_var_perm, **opts
            )
    return BPDecoder.from_check_matrix(H, **opts)


def make_spacetime_bp_decoder(H, num_rounds: int, **opts):
    """Multi-round structured spacetime BP
    (:class:`~exp_ldpc_tpu.decoders.spacetime_bp.SpacetimeBPDecoder`).

    ``H`` is the BASE check matrix; ``num_rounds`` the measurement rounds.
    The core picks the one-hot matmul routing for small base codes and the
    static-gather routing for large ones (``bp.resolve_use_matmul``), whose
    memory grows only linearly in rounds·n.  The reference delegates every
    size to serial Cython BP on the assembled spacetime matrix
    (``/root/reference/python/qldpc/misc/_experiment.py:62-83``)."""
    from .spacetime_bp import SpacetimeBPDecoder

    bp_backend()
    enable_compilation_cache()
    return SpacetimeBPDecoder.from_check_matrix(H, num_rounds, **opts)


def qc_kwargs_for_code(code, sector: str = "z") -> Dict:
    """``make_bp_decoder`` QC kwargs for decoding a code's X or Z sector
    (empty dict when the code carries no block-circulant metadata)."""
    meta = getattr(code, "qc_meta", None)
    if meta is None:
        return {}
    return {
        "qc_dims": meta.dims,
        "qc_check_perm": meta.check_perm(sector),
        "qc_var_perm": meta.qubit_perm,
    }


def qc_kwargs_single_shot(code, sector: str = "z") -> Dict:
    """QC kwargs for the single-shot matrix (H|I) of a sector.

    The identity block appended for measurement-error columns
    (``decoders/spacetime.py``, reference ``spacetime_code.py:10-37``) is
    itself circulant, so (H|I) stays block-circulant: the measurement
    columns permute with the CHECK permutation.
    """
    meta = getattr(code, "qc_meta", None)
    if meta is None:
        return {}
    H = code.checks.z if sector == "z" else code.checks.x
    r, n = H.shape
    check_perm = meta.check_perm(sector)
    qperm = meta.qubit_perm
    if check_perm is None and qperm is None:
        var_perm = None
    else:
        cp = np.arange(r) if check_perm is None else check_perm
        qp = np.arange(n) if qperm is None else qperm
        var_perm = np.concatenate([qp, n + cp])
    return {
        "qc_dims": meta.dims,
        "qc_check_perm": check_perm,
        "qc_var_perm": var_perm,
    }
