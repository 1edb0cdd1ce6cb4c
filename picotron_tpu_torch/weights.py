"""Carry parameters between the JAX package's pytree and the port's modules.

The JAX pytree (picotron_tpu/models/llama.py init_params) stacks layer
params on a leading [L, ...] axis and stores matmul weights [in, out]
(x @ w); the port keeps one `DecoderLayer` per layer with [out, in]
weights (F.linear). Both take numpy arrays, so tests feed the same numbers
to both frameworks.
"""

from __future__ import annotations

import numpy as np
import torch

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.parallel.sharding import shard_state_dict

# layer leaves that are matmul weights (transposed between the layouts)
_MATMUL = ("q", "k", "v", "o", "gate", "up", "down")
_VECTORS = ("input_norm", "post_norm", "b_q", "b_k", "b_v")


def params_from_jax(np_tree: dict, cfg: ModelConfig, tp_rank: int = 0,
                    tp_size: int = 1) -> dict:
    """JAX param pytree (numpy leaves) -> the port's state_dict (fp32
    tensors on the CPU; load with `model.load_state_dict`): the whole
    model, or with `tp_size` > 1 tp rank `tp_rank`'s shards of it
    (`parallel/sharding.py`)."""
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE weights are not ported yet (ROADMAP Queue 1 item 10)")
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    sd = {"embedding": t(np_tree["embedding"]),
          "final_norm": t(np_tree["final_norm"])}
    if cfg.tie_word_embeddings:
        if "lm_head" in np_tree:
            raise ValueError("tied model, but the tree has an lm_head")
    else:
        sd["lm_head"] = t(np.asarray(np_tree["lm_head"]).T)
    layers = np_tree["layers"]
    for i in range(cfg.num_hidden_layers):
        for name, stacked in layers.items():
            a = np.asarray(stacked)[i]
            if name in _MATMUL:
                a = a.T
            elif name not in _VECTORS:
                raise KeyError(f"unknown layer leaf {name!r}")
            sd[f"layers.{i}.{name}"] = t(a)
    return shard_state_dict(sd, tp_rank, tp_size)


def params_to_numpy(model: torch.nn.Module, grads: bool = False) -> dict:
    """The port's params (or, with grads=True, their .grad) -> the JAX
    pytree layout (numpy fp32 leaves)."""
    def f(p):
        x = p.grad if grads else p
        return x.detach().float().cpu().numpy()

    tree = {"embedding": f(model.embedding), "final_norm": f(model.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = f(model.lm_head).T.copy()
    names = _MATMUL + ("input_norm", "post_norm")
    if model.cfg.attention_bias:
        names += ("b_q", "b_k", "b_v")
    layers = {}
    for name in names:
        leaves = [f(getattr(lp, name)) for lp in model.layers]
        if name in _MATMUL:
            leaves = [a.T for a in leaves]
        layers[name] = np.stack(leaves)
    tree["layers"] = layers
    return tree
