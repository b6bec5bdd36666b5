"""Analysis of the port's work (the counterpart of ``repro.analysis``):
``roofline`` (the model's useful flops, the roofline report,
``count_costs``, the flops, bytes, collectives and peak memory one eager
call must do, and ``analyze`` / ``collective_bytes``, which read one
rank's count for the dry run, ``launch/dryrun.py``) and ``launch_audit``
(the device work of one replay of the live captured decode step, held
against the one-card policy).  The lint and ``analyze_calibrated`` are
not ported yet (ROADMAP.md A.7b)."""
from .roofline import (Costs, RooflineReport, analyze, collective_bytes,
                       count_costs, flash_attention_hbm_bytes, format_row,
                       model_flops, save_report)

__all__ = ["Costs", "RooflineReport", "analyze", "collective_bytes",
           "count_costs", "flash_attention_hbm_bytes", "format_row",
           "model_flops", "save_report"]
