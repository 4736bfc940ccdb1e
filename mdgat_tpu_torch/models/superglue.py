"""SuperGlue baseline (Sarlin et al., CVPR 2020) adapted to 3D keypoints.

Port of ``mdgat_tpu/models/superglue.py`` (reference
``models/superglue.py:315-625``): MDGAT with full attention in every GNN
layer; encoders, optimal transport, match decision and losses are shared,
and so is the state dict, so one checkpoint loads into either net.

As in the JAX package this is the intended baseline, not the reference's
``--net superglue`` path as shipped (that one crashes: its FPFH branches
call the GNN with arguments it does not take and read ground-truth keys the
data layer never writes).

On a CUDA device with ``use_kernels`` every layer runs the eval-layer
kernels with the attention kernel's dense arm
(``Config.layer_k_schedule`` is all-None for this net).
"""

from __future__ import annotations

from mdgat_tpu_torch.core.config import Config
from mdgat_tpu_torch.models.mdgat import MDGAT


class SuperGlue(MDGAT):
    def __init__(self, config: Config):
        # full attention everywhere: layer_k_schedule is all-None for it
        super().__init__(config.replace(net="superglue"))
