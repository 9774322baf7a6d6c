"""Descriptor matching: Hamming top-2 kernels and the projection/epipolar searches."""
from .core import (  # noqa: F401
    hamming_matrix,
    unpack_bits_pm1,
    best_match,
    mutual_best,
    rotation_consistency_mask,
    TH_LOW,
    TH_HIGH,
)
