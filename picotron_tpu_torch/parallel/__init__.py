"""The parallel layouts on torch.distributed (port of picotron_tpu/parallel/):
the collectives (`comm`), the data-group seam (`api`) with the
hierarchical multi-slice reduction (`hier_reduce`), Megatron tp (`tp`,
`sharding`) and its 2d / row-first strategies and deferred sync
(`tp_strategies`), context parallelism's per-rank context (`cp`),
expert parallelism's (`ep`) and the fused grad engine (`fused_bwd`), and
pipeline parallelism: one walk of a schedule table per rank (`pp`), fed
the spmd engines' tables or the mpmd ones (`mpmd`)."""
