"""Autoregressive generation with a KV cache (port of
picotron_tpu/generate.py and tools/generate.py).

    python -m picotron_tpu_torch.generate --config cfg.json \\
        --ckpt-dir ckpt --prompt-ids 12,7,99 --max-new-tokens 16
    python -m picotron_tpu_torch.generate --model SmolLM-1.7B \\
        --hf-dir ./hf_model --prompt-ids 12,7,99 --load-dtype bfloat16
    torchrun --nproc_per_node 2 -m picotron_tpu_torch.generate --tp 2 ...

It runs on CUDA unless `--device cpu` is passed; it never falls back.

The decode design is the JAX package's:

- The cache is allocated at the sequence's final length up front; the
  prompt is prefilled in one batched pass and each decode step writes one
  slot per layer, in place.
- Attention against the cache is plain torch, as the JAX package's is
  plain jnp (`_cached_attention`): an einsum for the scores, an fp32
  softmax, an einsum for the output. Decode is a GEMV-shaped, memory-bound
  workload where a flash kernel buys nothing, and the JAX package has no
  decode kernel to port. GQA stays unexpanded in the cache (Hkv heads);
  queries are grouped at score time.
- The layers are the training model's (`models/llama.py`: `qkv_proj`,
  `_o_proj`, `_mlp_block` or `_moe_block`, `embed`, `final_hidden`,
  `logits_from_hidden`), so decode runs on the trained params unchanged,
  and under tp on a rank's shards through the model's own f/g hooks and
  vocab-parallel embedding and head (`place_for_decode`). Each rank's
  cache then holds its Hkv/tp heads.
- `_decode_layers` is cache-agnostic: `KVCache` here (contiguous) and
  `serve.paged_cache.PagedKVCache` expose `num_layers`, `slots(q_pos)`
  (where a segment's K/V goes), `write(li, k, v, slots)` and
  `layer_view(li)`, so paged-vs-contiguous greedy parity is a structural
  property.
- No host sync inside the layers: RoPE gathers its table rows at the
  clamped positions (`rope_rows`), where `ops/rope.apply_rope` reads
  `positions.max()` on the host to bound-check. What depends on the
  positions alone (the RoPE rows, the causal mask, the cache slots) is
  computed once per call, not per layer: eager decode is bound by its
  host's kernel launches (PERF.md).

Sampling: greedy (temperature 0), temperature and top-k, drawing from an
explicit `torch.Generator` (Gumbel noise, then argmax). The JAX package's
RNG cannot be matched; greedy tokens are held to it, sampled ones are
deterministic under a fixed generator.

MoE models decode through `_moe_block`, as the JAX `_decode_layers` does,
so the expert capacity is per call: N = B * s tokens of that call (the
prompt's in the prefill, B in a decode step), without expert
parallelism and with per-call router statistics.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.models.llama import (
    LlamaModel, _mlp_block, _moe_block, _o_proj, compute_dtype, embed,
    final_hidden, logits_from_hidden, model_rope_tables, qkv_proj,
)
from picotron_tpu_torch.ops.rmsnorm import rms_norm

# decode steps between host reads of the EOS flags in `generate`: a row
# that is done keeps emitting EOS, so exiting at the next check gives the
# same tokens as exiting at the first step where every row is done
EOS_CHECK_EVERY = 8


def kv_heads(model: LlamaModel) -> int:
    """The kv heads this model (or tp rank) holds."""
    return model.layers[0].k.shape[0] // model.cfg.head_dim


def model_device(model: LlamaModel) -> torch.device:
    return model.final_norm.device


class KVCache:
    """Per-layer contiguous key/value cache, [L, B, S_max, Hkv, D] each,
    written in place. One of the two caches `_decode_layers` runs against
    (the other is `serve.paged_cache.PagedKVCache`)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k, self.v = k, v

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    def slots(self, q_pos):
        """Where a segment at positions q_pos goes: slot j holds position
        j. Needs the batch-shared [s] positions form (the offline
        arrangement: every sequence at the same offset)."""
        return q_pos

    def write(self, li: int, k_new, v_new, slots) -> "KVCache":
        """Write this segment's K/V [B, s, Hkv, D] into `slots` of layer
        li."""
        self.k[li].index_copy_(1, slots, k_new)
        self.v[li].index_copy_(1, slots, v_new)
        return self

    def layer_view(self, li: int):
        """([B, S_max, Hkv, D], same) of layer li, slot j holding the
        token at position j."""
        return self.k[li], self.v[li]


def init_cache(cfg: ModelConfig, batch: int, max_length: int, device=None,
               heads: Optional[int] = None) -> KVCache:
    """Zeroed cache in the compute dtype; `heads` defaults to the model's
    Hkv (a tp rank's cache holds Hkv/tp: `kv_heads(model)`)."""
    shape = (cfg.num_hidden_layers, batch, max_length,
             heads or cfg.num_key_value_heads, cfg.head_dim)
    dt = compute_dtype(cfg)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def rope_rows(cos, sin, q_pos):
    """The RoPE table rows of positions q_pos, shaped to broadcast over
    [B, s, H, D/2]: q_pos [s] (batch-shared, the offline path) or [B, s]
    (per sequence, continuous batching, where every slot sits at its own
    depth). Positions are clamped into the table: negative ones (the
    serving prefill's chunk padding, idle slots) rotate by position 0,
    and ones past the table (a decode interval running past a request's
    budget) by its last row. Their K/V never lands in a live cache slot
    and their outputs are discarded; the clamp is what the JAX gather
    does to such indices, and keeps the gather free of a host-side bound
    check."""
    idx = q_pos.clamp(0, cos.shape[0] - 1)
    c, s = cos[idx], sin[idx]
    if q_pos.dim() == 1:
        return c[None, :, None, :], s[None, :, None, :]
    return c[:, :, None, :], s[:, :, None, :]


def _rope(x, rows):
    """Rotate-half RoPE of x [B, s, H, D] by `rope_rows`, in fp32."""
    c, s = rows
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def masked_slots(q_pos, s_max: int):
    """True where a query at q_pos must not see cache slot j < s_max
    (j > q_pos), shaped to broadcast over the [B, Hkv, G, s, S_max]
    scores. A negative q_pos clamps to 0 so its row stays finite (an
    all-masked row would softmax to NaN and flow through the later
    layers)."""
    out = (torch.arange(s_max, device=q_pos.device)
           > q_pos.clamp(min=0)[..., None])
    return out[None, None, None] if out.dim() == 2 else out[:, None, None]


def _cached_attention(q, ck, cv, masked):
    """q [B, s, Hq, D]; ck/cv [B, S_max, Hkv, D] with slot j holding the
    token at position j (zeros or stale beyond the filled length: masked
    by causality (`masked_slots`), since every filled slot index <=
    max(q_pos); exact zeros under softmax leave the valid rows
    bit-identical for any S_max). Returns [B, s, Hq, D]."""
    b, s, hq, d = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, ck).float() / (d ** 0.5)
    scores = scores.masked_fill(masked, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", p, cv)
    return out.reshape(b, s, hq, d)


def _decode_layers(model: LlamaModel, x, cache, q_pos, cos, sin):
    """Every layer over x [B, s, H] (prefill: s = prompt length, decode:
    s = 1), writing this segment's K/V into `cache` at q_pos, in place.
    Returns the hidden states."""
    cfg = model.cfg
    rows = rope_rows(cos, sin, q_pos)
    slots = cache.slots(q_pos)
    masked = None
    for li, lp in enumerate(model.layers):
        h = rms_norm(x, lp.input_norm, cfg.rms_norm_eps)
        q, k, v = qkv_proj(h, lp, cfg.head_dim)
        q, k = _rope(q, rows), _rope(k, rows)
        cache.write(li, k, v, slots)
        ck, cv = cache.layer_view(li)
        if masked is None:
            masked = masked_slots(q_pos, ck.shape[1])
        x = x + _o_proj(_cached_attention(q, ck, cv, masked), lp)
        if lp.moe:
            x = x + _moe_block(x, lp, cfg)[0]
        else:
            x = x + _mlp_block(x, lp, cfg)
    return x


def _logits_last(model: LlamaModel, x) -> torch.Tensor:
    """Logits of the LAST position only: [B, V] fp32 (gathered under tp)."""
    hf = final_hidden(model, x[:, -1:])
    return logits_from_hidden(model, hf)[:, 0].float()


def top_k_mask(logits, top_k: int):
    """logits with everything below the k-th largest of each row at -inf
    (top_k 0: unchanged)."""
    if top_k <= 0:
        return logits
    kth = logits.topk(top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in (0, 1): argmax(logits + gumbel(u)) is
    a draw from softmax(logits)."""
    return -torch.log(-torch.log(u))


def _sample(logits, temperature: float, top_k: int,
            generator: torch.Generator):
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    lg = top_k_mask(logits / temperature, top_k)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    return (lg + gumbel(u)).argmax(dim=-1)


@torch.no_grad()
def generate(model: LlamaModel, prompt_ids, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0,
             eos_token_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt_ids [B, P] -> [B, P + max_new_tokens] int64 on the model's
    device (tokens after an EOS are EOS when eos_token_id is given);
    greedy when temperature == 0. `generator` (on the model's device)
    draws the samples; default: seeded 0."""
    cfg = model.cfg
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    dev = model_device(model)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.as_tensor(prompt_ids, dtype=torch.long, device=dev)
    b, p_len = prompt.shape
    max_len = p_len + max_new_tokens
    # tables sized to the positions indexed, not max_position_embeddings
    cos, sin = model_rope_tables(cfg, max_len=max_len, device=dev)
    cache = init_cache(cfg, b, max_len, device=dev, heads=kv_heads(model))
    positions = torch.arange(max_len, device=dev)

    x = _decode_layers(model, embed(model, prompt), cache,
                       positions[:p_len], cos, sin)
    tok = _sample(_logits_last(model, x), temperature, top_k, generator)
    out = torch.full((b, max_new_tokens),
                     0 if eos_token_id is None else eos_token_id,
                     dtype=torch.long, device=dev)
    out[:, 0] = tok
    done = None if eos_token_id is None else tok == eos_token_id
    for i in range(1, max_new_tokens):
        if (done is not None and i % EOS_CHECK_EVERY == 0
                and bool(done.all())):
            break  # the rest of `out` is already EOS
        # step i feeds the token sampled at step i-1, which sits at
        # position p_len + i - 1 (one off rotates RoPE wrong, writes K/V
        # a slot late and attends a never-written slot)
        pos = positions[p_len + i - 1:p_len + i]
        x = _decode_layers(model, embed(model, tok[:, None]), cache, pos,
                           cos, sin)
        nxt = _sample(_logits_last(model, x), temperature, top_k,
                      generator)
        if done is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out[:, i] = nxt
        tok = nxt
    return torch.cat([prompt, out], dim=1)


def load_for_decode(state_dict: dict, cfg: ModelConfig, device,
                    tp=None) -> LlamaModel:
    """A model holding `state_dict` (whole, or a tp rank's shards under
    the tp context `tp`) at the dict's own dtypes on `device`: the
    tensors are assigned, never copied into an fp32 model first, so a
    bf16 load never materializes fp32 params."""
    model = LlamaModel(cfg, device="meta", tp=tp)
    model.load_state_dict(state_dict, assign=True)
    model.rope_cos, model.rope_sin = model_rope_tables(cfg)
    return model.to(device)


def place_for_decode(params: dict, model_cfg: ModelConfig, tp: int = 1,
                     device="cuda") -> LlamaModel:
    """The model to decode with, from a whole state dict: on `device` at
    tp 1; at tp > 1 this rank's shards under a tp context over a process
    group of tp ranks (`mesh.init_parallel`: an initialized group or
    torchrun's environment; NCCL on CUDA, each rank on cuda:LOCAL_RANK).
    Heads or vocab that tp does not divide raise ValueError, as the JAX
    package's `place_for_decode` does (the config's own checks)."""
    from picotron_tpu_torch.config import (
        Config, DistributedConfig, TrainingConfig,
    )
    from picotron_tpu_torch.mesh import init_parallel
    from picotron_tpu_torch.parallel.sharding import shard_state_dict
    from picotron_tpu_torch.parallel.tp import tp_context

    # the training section is irrelevant to decode; seq_length=1 keeps
    # validate() on what matters here (heads and vocab % tp)
    cfg = Config(distributed=DistributedConfig(tp_size=tp), model=model_cfg,
                 training=TrainingConfig(seq_length=1))
    cfg.validate()
    dev = torch.device(device)
    if tp == 1:
        return load_for_decode(params, model_cfg, dev)
    par = init_parallel(cfg, dev)  # raises unless the world is tp ranks
    return load_for_decode(shard_state_dict(params, par.tp_rank, tp),
                           model_cfg, par.device, tp=tp_context(par))


# ---------------------------------------------------------------------------
# CLI (port of tools/generate.py)
# ---------------------------------------------------------------------------


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m picotron_tpu_torch.generate",
        description="picotron-tpu (PyTorch port) generation")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf-dir", help="HF safetensors directory")
    src.add_argument("--ckpt-dir", help="the port's checkpoint save_dir")
    ap.add_argument("--model", default=None,
                    help="model preset name (required with --hf-dir)")
    ap.add_argument("--config", default=None,
                    help="training config JSON (required with --ckpt-dir)")
    prompt = ap.add_mutually_exclusive_group(required=True)
    prompt.add_argument("--prompt", help="text (needs --tokenizer-dir)")
    prompt.add_argument("--prompt-ids", help="comma-separated token ids")
    ap.add_argument("--tokenizer-dir", default=None,
                    help="a tokenizer directory already on disk (for "
                         "--prompt; nothing is downloaded)")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel decode over this many ranks "
                         "(launch with torchrun --nproc_per_node TP)")
    ap.add_argument("--load-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="dtype to load the params in (bfloat16 halves "
                         "their memory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)

    from picotron_tpu_torch.checkpoint import (
        load_hf_safetensors, restore_params_only,
    )
    from picotron_tpu_torch.config import load_config, resolve_preset
    from picotron_tpu_torch.mesh import shutdown
    from picotron_tpu_torch.utils import cuda_or_cpu

    if args.prompt is not None and not args.tokenizer_dir:
        ap.error("--prompt needs --tokenizer-dir, a tokenizer directory "
                 "already on disk (nothing is downloaded); or pass raw "
                 "token ids with --prompt-ids")
    dev = cuda_or_cpu(args.device)
    load_dtype = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}[args.load_dtype]
    if args.hf_dir:
        if not args.model:
            ap.error("--hf-dir needs --model <preset>")
        cfg_m = ModelConfig(name=args.model, **resolve_preset(args.model))
        params = load_hf_safetensors(args.hf_dir, cfg_m,
                                     dtype=load_dtype or torch.float32)
    else:
        if not args.config:
            ap.error("--ckpt-dir needs --config <json>")
        cfg = load_config(args.config)
        cfg_m = cfg.model
        params, _ = restore_params_only(cfg, args.ckpt_dir, dtype=load_dtype)

    tokenizer = None
    if args.prompt is not None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer_dir,
                                                  local_files_only=True)
        ids = tokenizer(args.prompt)["input_ids"]
    else:
        ids = [int(t) for t in args.prompt_ids.split(",")]
    try:
        model = place_for_decode(params, cfg_m, tp=args.tp, device=dev)
        gen = torch.Generator(device=model_device(model))
        gen.manual_seed(args.seed)
        out = generate(model, [ids], args.max_new_tokens,
                       temperature=args.temperature, top_k=args.top_k,
                       eos_token_id=(tokenizer.eos_token_id
                                     if tokenizer is not None else None),
                       generator=gen)[0].tolist()
        if model.tp is None or model.tp.rank == 0:
            if tokenizer is not None:
                print(tokenizer.decode(out, skip_special_tokens=True))
            else:
                print(",".join(str(t) for t in out))
    finally:
        if args.tp > 1:
            shutdown()
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
