"""visdial_tpu_torch — the PyTorch + CUDA port of visdial_tpu for NVIDIA Hopper.

The JAX package `visdial_tpu` is the reference; each module here names its
counterpart there.  This package imports torch and never JAX, and nothing
of the JAX package: it keeps its own copies of the configuration
(config.py) and of the data modules it needs (data/).

It does what the JAX package does but its bench script: all nine encoders
with either decoder, trained (train.py), evaluated (eval_harness.py,
evaluate.py), fine-tuned, swept, decoded (generate.py) and served
(infer.py), on one card or a (data, model) grid of them
(parallel/mesh.py); the data CLIs (data/prepro.py, data/ingest_h5.py,
data/prepro_img.py), the verify gate and the parity runbook
(parity_run.py).  Every TPU kernel is a hand-written CUDA kernel
(csrc/).
"""

from .config import Config

__all__ = ["Config"]
