"""Descriptor matching: Hamming top-2 kernels and the projection/epipolar searches."""
