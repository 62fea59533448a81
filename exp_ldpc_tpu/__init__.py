"""exp_ldpc_tpu — framework for practical realization of general quantum
LDPC codes, running on NVIDIA GPUs.

Covers the reference's full public surface
(``/root/reference/python/qldpc/__init__.py:1-13``, SURVEY.md §2.2) with a
device-native compute path: code construction and circuit generation run on
host (bit-packed GF(2) + C++ kernels), sampling and decoding run as batched
JAX/XLA programs, and Monte-Carlo experiments shard over device
meshes.
"""
from .circuits.noise import circuit_noise, depolarizing_noise, trivial_noise
from .circuits.storage_sim import build_perfect_circuit, build_storage_simulation
from .codes import lifted as lifted_product_code
from .codes import matrix_lifted as matrix_lifted_product_code
from .codes.graphs import edge_color_bipartite, random_biregular_graph, remove_short_cycles
from .codes.hgp import biregular_hgp, random_test_hgp
from .codes.homological import homological_product
from .codes.io import read_quantum_code, write_quantum_code
from .codes.lifted import lifted_product_code_cyclic, lifted_product_code_pgl2
from .codes.qc_lifted import qc_lifted_product_code
from .codes.bivariate_bicycle import BB_CODES, bivariate_bicycle_code, gross_code
from .codes.random_code import random_check_matrix
from .codes.routing import grid_permutation_route, product_permutation_route
from .codes.surface import repetition_code_checks, surface_code, toric_code
from .core import (
    GF2,
    CircuitTargets,
    NoiseRewriter,
    QuantumCode,
    QuantumCodeChecks,
    QuantumCodeLogicals,
    StorageSim,
    make_check_matrix,
)
from .decoders.spacetime import DetectorSpacetimeCode, SpacetimeCode, SpacetimeCodeSingleShot
from . import code_examples, noise_model

__all__ = [
    "GF2",
    "build_storage_simulation",
    "build_perfect_circuit",
    "edge_color_bipartite",
    "biregular_hgp",
    "random_test_hgp",
    "random_biregular_graph",
    "remove_short_cycles",
    "homological_product",
    "qc_lifted_product_code",
    "lifted_product_code",
    "lifted_product_code_pgl2",
    "lifted_product_code_cyclic",
    "matrix_lifted_product_code",
    "random_check_matrix",
    "bivariate_bicycle_code",
    "gross_code",
    "BB_CODES",
    "toric_code",
    "surface_code",
    "repetition_code_checks",
    "read_quantum_code",
    "write_quantum_code",
    "grid_permutation_route",
    "product_permutation_route",
    "QuantumCode",
    "QuantumCodeChecks",
    "QuantumCodeLogicals",
    "CircuitTargets",
    "NoiseRewriter",
    "StorageSim",
    "make_check_matrix",
    "SpacetimeCode",
    "SpacetimeCodeSingleShot",
    "DetectorSpacetimeCode",
    "noise_model",
    "code_examples",
    "trivial_noise",
    "depolarizing_noise",
    "circuit_noise",
]
