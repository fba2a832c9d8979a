"""kbslam_torch — the kbslam tracking step in PyTorch, for CUDA GPUs.

A port of the JAX package ``kbslam`` (which stays the reference). Plain
tensor code is eager PyTorch; the one Pallas kernel of the tracking
path (batched patch extraction) is a hand-written CUDA kernel, and the
main path runs it fused with the two stages that read its patches
(``kbslam_torch/csrc/describe.cu``), built with ``nvcc`` at first use.

This package imports torch and numpy only and stands on its own: it
never imports JAX or the ``kbslam`` package, and keeps its own copies
of the numpy-only modules it needs (``config``, ``io.synthetic``,
``eval.trajectory``) and of the BRIEF sampling pattern.
"""
from kbslam_torch import config as _config

SLAMConfig = _config.SLAMConfig
DEFAULT_CONFIG = _config.DEFAULT_CONFIG

__version__ = "0.2.0"
