"""The parallel layouts on torch.distributed (port of picotron_tpu/parallel/):
the collectives (`comm`), the data-group seam (`api`), Megatron tp
(`tp`, `sharding`), context parallelism's per-rank context (`cp`) and
the fused grad engine (`fused_bwd`). Pipeline parallelism and the tp
strategies are ROADMAP Queue 1 item 9."""
