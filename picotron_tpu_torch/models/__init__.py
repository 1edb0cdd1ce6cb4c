from picotron_tpu_torch.models.llama import (  # noqa: F401
    LlamaModel, forward, init_params, loss_fn, loss_sum_count,
)
