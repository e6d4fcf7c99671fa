"""Evaluation metrics: L3DAS21 location-sensitive detection + DCASE21 SELD
(the port's own copies of ``seld_tpu/metrics``)."""

from seld_tpu_torch.metrics.dcase21 import SELDMetrics, segment_labels  # noqa: F401
from seld_tpu_torch.metrics.decode import gen_submission_list_task2  # noqa: F401
from seld_tpu_torch.metrics.lsd import location_sensitive_detection  # noqa: F401
