"""visdial_tpu_torch — the PyTorch + CUDA port of visdial_tpu for NVIDIA Hopper.

The JAX package `visdial_tpu` is the reference; each module here names its
counterpart there.  This package imports torch and never JAX: of the JAX
package it uses only the JAX-free shared modules (`visdial_tpu.config` and
`visdial_tpu.data.{dataset,loader,synthetic,prepro,native}`).

Ported so far: the MN-family disc serving path (infer.py), with the masked
LSTM forward and the attention + fusion tail as hand-written CUDA kernels
(csrc/).  ROADMAP.md lists what is still to be ported.
"""

from visdial_tpu.config import Config

__all__ = ["Config"]
