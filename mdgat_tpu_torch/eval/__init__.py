from mdgat_tpu_torch.eval.metrics import (
    AverageMeter, TestEvalAccumulator, matching_metrics,
    merge_meter_records, pack_meter_records, pose_metrics,
    registration_batch_metrics, registration_summary,
)
