"""Command-line tools of the port, each `python -m
picotron_tpu_torch.tools.<name>`: the telemetry readers `telemetry_report`
and `trace_export`; the checkpoint tools `ckpt_doctor` (verify a
save_dir's lineage, GC), `elastic_resize` (re-stamp a step for another
dp/pp layout) and `export_hf`; the run tools `chaos` (fault-recovery
scenarios), `create_config`, `submit_jobs` (launch a directory of runs
under torchrun or slurm), `extract_metrics` and `trace_summary` (a
`logging.profile_dir` trace by kernel); the serving driver
`serve_bench`; `layout_planner` (rank layouts by the cost model's
predicted step) and `data_bench` (the host's dataset reads, CPU only)."""
