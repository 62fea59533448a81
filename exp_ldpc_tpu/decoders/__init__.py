"""Decoding stack: batched BP (XLA formulations), relay-BP ensembles,
OSD post-processing, spacetime/DEM matrix builders, and decode-mode drivers.
"""
from .bp import BPDecoder, bp_decode_batch, priors_to_llr
from .bp_int8 import Int8BPDecoder
from .bposd import BPOSDDecoder
from .flip import FlipDecoder, SmallSetFlipDecoder
from .qc_bp import QCBPDecoder, QCStructure
from .select import (bp_backend, make_bp_decoder, make_spacetime_bp_decoder,
                     qc_kwargs_for_code, qc_kwargs_single_shot)
from .osd import osd_decode, osd_decode_batch
from .relay_bp import RelayBPDecoder, relay_bp_decode_batch
from .spacetime import DetectorSpacetimeCode, SpacetimeCode, SpacetimeCodeSingleShot
from .spacetime_bp import SpacetimeBPDecoder
from .tanner import TannerELL

__all__ = [
    "BPDecoder",
    "Int8BPDecoder",
    "BPOSDDecoder",
    "FlipDecoder",
    "SmallSetFlipDecoder",
    "QCBPDecoder",
    "QCStructure",
    "bp_backend",
    "make_bp_decoder",
    "make_spacetime_bp_decoder",
    "qc_kwargs_for_code",
    "qc_kwargs_single_shot",
    "SpacetimeBPDecoder",
    "RelayBPDecoder",
    "TannerELL",
    "SpacetimeCode",
    "SpacetimeCodeSingleShot",
    "DetectorSpacetimeCode",
    "bp_decode_batch",
    "relay_bp_decode_batch",
    "osd_decode",
    "osd_decode_batch",
    "priors_to_llr",
]
