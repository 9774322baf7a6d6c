"""orb_slam2_tpu_torch — the PyTorch/CUDA port of orb_slam2_tpu.

A second package beside the JAX reference ``orb_slam2_tpu``, with the
same subpackage layout and module names (``ops``, ``matching``,
``geom``, ``optim``, ``models``, ``pipeline``, ``parallel``, ``utils``,
``io``) so each port module sits where its counterpart does.  It
imports torch and never jax.  Ported: everything the JAX package has:
both tracking modes (pose prior, pipelined or not, and estimated), local
mapping (inline or on a mapping thread), place recognition, loop
closing, relocalization, map save/load and localization mode, the
distributed solvers (``parallel``: observation-, point- and
edge-sharded BA and pose graph on a mesh of local devices or of
``torch.distributed`` ranks; global BA shards over several local
cards), the live viewer (``utils.viewer``, ``utils.viz``) and the
command line (``python -m orb_slam2_tpu_torch.cli``, ``--viz``) with
its dataset and vocabulary I/O.  Every kernel the JAX package wrote in
Pallas is hand-written CUDA for Hopper (``csrc/``, built and loaded by
``kernels``):

- K1 ``ops.fast.score_maps``        (FAST score maps, a frame's levels
  in one launch)
- K2 ``matching.hamming_top2.masked_top2_mutual`` (windowed top-2)
- K3 ``matching.hamming_top2.masked_top2_epi``    (epipolar top-2)
- K4 ``matching.hamming_top2.hamming_top2``       (unmasked top-2; no
  pipeline caller, as in the JAX package)

Each has a plain PyTorch version beside it that runs for CPU tensors.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and LM solves need true float32 products: no TF32 in matmuls
# or cuDNN (the JAX package forces the same with
# jax_default_matmul_precision="highest").
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
