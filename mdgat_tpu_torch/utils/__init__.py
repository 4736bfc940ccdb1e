from mdgat_tpu_torch.utils.logging import ScalarLogger
from mdgat_tpu_torch.utils.profiling import PhaseTimer, span
