"""Command-line tools of the port that read the trainer's telemetry:
`python -m picotron_tpu_torch.tools.telemetry_report` and
`python -m picotron_tpu_torch.tools.trace_export`."""
