"""Carry parameters between the JAX package's pytree and the port's modules.

The JAX pytree (picotron_tpu/models/llama.py init_params) stacks layer
params on a leading [L, ...] axis and stores matmul weights [in, out]
(x @ w); the port keeps one `DecoderLayer` per layer with [out, in]
weights (F.linear). Both take numpy arrays, so tests feed the same numbers
to both frameworks. Under an uneven pipeline split the JAX stack is padded
with identity layers (`pp_layer_placement`); the port holds no pad
layers, so the transplant reads each real layer from its slot. The MoE
router [H, E] and banks [E, H, F] / [E, F, H] keep the JAX layout.
"""

from __future__ import annotations

import numpy as np
import torch

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.models.llama import pp_layer_placement
from picotron_tpu_torch.parallel.sharding import shard_state_dict

# layer leaves that are matmul weights (transposed between the layouts)
_MATMUL = ("q", "k", "v", "o", "gate", "up", "down")
_VECTORS = ("input_norm", "post_norm", "b_q", "b_k", "b_v")
# layer leaves kept in the JAX layout (the MoE router and banks)
_AS_IS = ("router", "w_gate", "w_up", "w_down")


def params_from_jax(np_tree: dict, cfg: ModelConfig, tp_rank: int = 0,
                    tp_size: int = 1, pp_size: int = 1, ep_rank: int = 0,
                    ep_size: int = 1) -> dict:
    """JAX param pytree (numpy leaves) -> the port's state_dict (fp32
    tensors on the CPU; load with `model.load_state_dict`, or
    `stage_params` for a pipeline stage): the whole model, or with
    `tp_size` > 1 tp rank `tp_rank`'s shards of it, and with `ep_size` >
    1 ep rank `ep_rank`'s experts (`parallel/sharding.py`). A layer stack
    padded for `pp_size` stages (the JAX state under an uneven split) is
    read through the real layers' slots."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    sd = {"embedding": t(np_tree["embedding"]),
          "final_norm": t(np_tree["final_norm"])}
    if cfg.tie_word_embeddings:
        if "lm_head" in np_tree:
            raise ValueError("tied model, but the tree has an lm_head")
    else:
        sd["lm_head"] = t(np.asarray(np_tree["lm_head"]).T)
    layers = np_tree["layers"]
    padded, slots = pp_layer_placement(cfg.num_hidden_layers, pp_size)
    for i in range(cfg.num_hidden_layers):
        for name, stacked in layers.items():
            stacked = np.asarray(stacked)
            a = stacked[slots[i] if stacked.shape[0] == padded else i]
            if name in _MATMUL:
                a = a.T
            elif name not in _VECTORS + _AS_IS:
                raise KeyError(f"unknown layer leaf {name!r}")
            sd[f"layers.{i}.{name}"] = t(a)
    return shard_state_dict(sd, tp_rank, tp_size, ep_rank, ep_size)


def stage_params(sd: dict, model: torch.nn.Module) -> dict:
    """The entries of a whole model's state dict `sd` that `model` (a
    pipeline stage) holds."""
    return {n: sd[n] for n, _ in model.named_parameters()}


def params_to_numpy(model: torch.nn.Module, grads: bool = False) -> dict:
    """The port's params (or, with grads=True, their .grad) -> the JAX
    pytree layout (numpy fp32 leaves)."""
    def f(p):
        x = p.grad if grads else p
        return x.detach().float().cpu().numpy()

    tree = {"embedding": f(model.embedding), "final_norm": f(model.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = f(model.lm_head).T.copy()
    names = (("q", "k", "v", "o") + _AS_IS if model.cfg.num_experts
             else _MATMUL) + ("input_norm", "post_norm")
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
