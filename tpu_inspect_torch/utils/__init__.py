"""Shared utilities: structured logging and stage timing."""

from tpu_inspect_torch.utils.logging import InspectionLog, stage_timer

__all__ = ["InspectionLog", "stage_timer"]
