"""Command-line tools of the port, each `python -m
picotron_tpu_torch.tools.<name>`: the telemetry readers `telemetry_report`
and `trace_export`; the checkpoint tools `ckpt_doctor` (verify a
save_dir's lineage, GC), `elastic_resize` (re-stamp a step for another
dp/pp layout) and `export_hf`; the run tools `chaos` (fault-recovery
scenarios), `create_config`, `extract_metrics` and `trace_summary` (a
`logging.profile_dir` trace by kernel)."""
