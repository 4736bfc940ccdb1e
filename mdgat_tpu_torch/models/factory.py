"""Model factory mirroring the reference's net selection
(``train.py:185-188``, ``test.py:152-156``; port of
``mdgat_tpu/models/factory.py``): 'superglue' builds the baseline; 'mdgat'
and 'raw' build MDGAT ('raw' forces k=None, full attention,
``train.py:130-132``); 'lightglue' builds LightGlue
(``models/lightglue.py``), which serves and does not train."""

from __future__ import annotations

from torch import nn

from mdgat_tpu_torch.core.config import Config
from mdgat_tpu_torch.models.lightglue import LightGlue
from mdgat_tpu_torch.models.mdgat import MDGAT
from mdgat_tpu_torch.models.superglue import SuperGlue


def build_model(config: Config) -> nn.Module:
    if config.net == "lightglue":
        return LightGlue(config)
    if config.net == "superglue":
        return SuperGlue(config)
    if config.net == "raw":
        return MDGAT(config.replace(k=None))
    return MDGAT(config)
