"""Analysis of the port's work on one card (the counterpart of
``repro.analysis``): ``roofline`` (the model's useful flops, the
roofline report, and ``count_costs``, the flops and bytes one eager call
must do) and ``launch_audit`` (the device work of one replay of the live
captured decode step, held against the one-card policy).  The lint and
the dry-run half of the roofline (``analyze``, ``analyze_calibrated``)
are not ported yet (ROADMAP.md)."""
from .roofline import (Costs, RooflineReport, count_costs,
                       flash_attention_hbm_bytes, format_row, model_flops,
                       save_report)

__all__ = ["Costs", "RooflineReport", "count_costs",
           "flash_attention_hbm_bytes", "format_row", "model_flops",
           "save_report"]
