"""PyTorch + CUDA port of mdgat_tpu (the MDGAT keypoint matcher).

The JAX package ``mdgat_tpu`` is the reference; this package imports
neither it nor JAX. On a CUDA device the GNN layers and the Sinkhorn run
hand-written Hopper kernels (``csrc/``, built with ``nvcc`` at first use);
on the CPU they run their plain PyTorch twins.
"""

from mdgat_tpu_torch.api import Matcher
from mdgat_tpu_torch.core.config import Config, test_defaults, train_defaults
from mdgat_tpu_torch.models.mdgat import MDGAT

__all__ = ["Config", "MDGAT", "Matcher", "test_defaults", "train_defaults"]
