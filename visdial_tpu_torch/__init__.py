"""visdial_tpu_torch — the PyTorch + CUDA port of visdial_tpu for NVIDIA Hopper.

The JAX package `visdial_tpu` is the reference; each module here names its
counterpart there.  This package imports torch and never JAX, and nothing
of the JAX package: it keeps its own copies of the configuration
(config.py) and of the data modules it needs (data/).

Ported so far: the MN-family encoders with the disc and gen decoders,
trained (train.py), evaluated (eval_harness.py) and served (infer.py), with
every TPU kernel of those paths as a hand-written CUDA kernel (csrc/).
ROADMAP.md lists what is still to be ported.
"""

from .config import Config

__all__ = ["Config"]
