"""The parallel layouts on torch.distributed (port of picotron_tpu/parallel/):
the collectives (`comm`), the data-group seam (`api`), Megatron tp
(`tp`, `sharding`), context parallelism's per-rank context (`cp`) and
the fused grad engine (`fused_bwd`), and pipeline parallelism: one walk
of a schedule table per rank (`pp`), fed the spmd engines' tables or the
mpmd ones (`mpmd`). The tp strategies are ROADMAP Queue 1 item 9."""
