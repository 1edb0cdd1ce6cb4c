"""Spec lint — the port's shard placement vs the model's parameters vs the
layout, statically (port of picotron_tpu/analysis/spec_lint.py).

The JAX package declares one PartitionSpec pytree; the port declares its
placement as functions of a parameter's name (`parallel/sharding.py`:
`tp_shard_dim`, `ep_shard_dim`, the "row" strategy's `tp_flips`), which
every reader of a shard (the model's tp context, the checkpoint, the HF
import, elastic resize) must agree with. `param_specs` spells that
placement as one spec per parameter of the whole model, a tuple with
one entry per dim (an axis name or None, the PartitionSpec form), and
`lint_specs` walks it against the parameters and the layout sizes,
reporting every mismatch by parameter name:

- a parameter with no placement, or a spec with no parameter;
- a spec with more entries than the parameter has dims;
- an unknown axis, or one axis sharding two dims;
- a dim the axis does not divide.

The JAX provenance audit's misspecced input (a tensor committed with one
spec and consumed under another, which GSPMD reshards) has its eager
counterpart here: `lint_param_specs` also holds each spec against the
shard a rank's model really holds (`held_splits`, built on meta), and a
disagreement is an error that names the fix.
"""

from __future__ import annotations

import math
from typing import Mapping

from picotron_tpu_torch.analysis.report import ERROR, Report
from picotron_tpu_torch.mesh import AXES

CHECK = "spec_lint"


def _spec_of(name: str, rank: int, flips) -> tuple:
    """A parameter's spec from `parallel/sharding.py` (KeyError when it
    has no tp placement)."""
    from picotron_tpu_torch.parallel.sharding import ep_shard_dim, tp_shard_dim

    spec = [None] * rank
    for axis, dim in (("tp", tp_shard_dim(name, flips)),
                      ("ep", ep_shard_dim(name))):
        if dim is not None:
            spec[dim] = axis
    return tuple(spec)


def shape_model(cfg, **contexts):
    """A meta LlamaModel of `cfg`'s model for its parameters' shapes (a
    cp schedule's attn_impl, which needs a cp context to build, is
    spelled "flash": the parameters do not depend on it)."""
    import dataclasses

    from picotron_tpu_torch.models.llama import LlamaModel

    m = cfg.model
    if m.attn_impl in ("ring", "ulysses", "mesh"):
        m = dataclasses.replace(m, attn_impl="flash")
    return LlamaModel(m, device="meta", **contexts)


def whole_shapes(cfg) -> dict:
    """{name: shape} of the whole model's parameters (a meta model)."""
    return {n: tuple(p.shape)
            for n, p in shape_model(cfg).named_parameters()}


def param_specs(cfg, shapes: dict = None) -> dict:
    """{name: spec} for every parameter `parallel/sharding.py` places;
    a parameter it cannot place has no entry (the lint's missing leaf)."""
    from picotron_tpu_torch.parallel.sharding import tp_flips

    shapes = whole_shapes(cfg) if shapes is None else shapes
    flips = tp_flips(cfg)
    out = {}
    for name, shape in shapes.items():
        try:
            out[name] = _spec_of(name, len(shape), flips)
        except KeyError:
            continue
    return out


def lint_specs(specs: Mapping[str, tuple], shapes: Mapping[str, tuple],
               axis_sizes: Mapping[str, int]) -> Report:
    """Core lint over a {name: spec} table and {name: shape}; pure host
    arithmetic, so the mutation tests can feed broken tables."""
    rep = Report()
    for name in sorted(set(specs) - set(shapes)):
        rep.add(CHECK, ERROR, name,
                "spec leaf has no matching param leaf (stale or misspelled "
                "entry in the placement)")
    for name in sorted(set(shapes) - set(specs)):
        rep.add(CHECK, ERROR, name,
                "param leaf has no placement (parallel/sharding.py cannot "
                "place it; it would be fully replicated by accident)")
    for name in sorted(set(specs) & set(shapes)):
        spec, shape = tuple(specs[name]), tuple(shapes[name])
        if len(spec) > len(shape):
            rep.add(CHECK, ERROR, name,
                    f"spec {spec} has {len(spec)} entries but the param "
                    f"has rank {len(shape)} (shape {shape})")
            continue
        seen: dict = {}
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (
                tuple(entry) if isinstance(entry, (tuple, list))
                else (entry,))
            for a in axes:
                if a not in axis_sizes:
                    rep.add(CHECK, ERROR, name,
                            f"dim {dim}: unknown layout axis {a!r} (axes: "
                            f"{tuple(axis_sizes)})")
                elif a in seen:
                    rep.add(CHECK, ERROR, name,
                            f"dim {dim}: axis {a!r} already shards dim "
                            f"{seen[a]} — an axis may shard at most one "
                            f"dimension")
                else:
                    seen[a] = dim
            factor = math.prod(axis_sizes.get(a, 1) for a in axes)
            if factor > 1 and shape[dim] % factor != 0:
                rep.add(CHECK, ERROR, name,
                        f"dim {dim} (size {shape[dim]}) is not divisible "
                        f"by axes {axes} (product {factor}) — each rank "
                        f"would need a ragged shard")
    rep.info[CHECK] = {
        "spec_leaves": len(specs),
        "param_leaves": len(shapes),
        "axes": dict(axis_sizes),
    }
    return rep


def held_splits(cfg, shapes: dict) -> dict:
    """{name: the factor each dim is split by} in what rank 0's model
    really holds under the layout (a meta model with the rank's tp and ep
    contexts): the whole dim over the held one."""
    from picotron_tpu_torch.analysis.trace import recording_env
    from picotron_tpu_torch.parallel.ep import ep_context
    from picotron_tpu_torch.parallel.tp import tp_context

    par = recording_env(cfg, 0, [])
    model = shape_model(cfg, tp=tp_context(
        par, cfg.distributed.sequence_parallel, cfg), ep=ep_context(par, cfg))
    return {name: tuple(w // h for w, h in zip(shapes[name], p.shape))
            for name, p in model.named_parameters()
            if name in shapes and len(shapes[name]) == p.dim()}


def _spec_for(splits: tuple, declared: tuple, axis_sizes: dict) -> tuple:
    """The spec that splits each dim as `splits` says: the declared axis
    where its size fits, else another axis of that size."""
    spec, used = [], set()
    for dim, f in enumerate(splits):
        axis = None
        if f > 1:
            mine = declared[dim] if dim < len(declared) else None
            cands = ([mine] if mine is not None else []) + list(axis_sizes)
            axis = next((a for a in cands if axis_sizes.get(a) == f
                         and a not in used), "?")
            used.add(axis)
        spec.append(axis)
    return tuple(spec)


def lint_param_specs(cfg) -> Report:
    """Config-level lint: `param_specs` against the whole model's
    parameters and the layout's sizes, then against what a rank's model
    holds (`held_splits`)."""
    d = cfg.distributed
    axis_sizes = dict(zip(AXES, (d.dp_size, d.pp_size, d.ep_size,
                                 d.cp_size, d.tp_size)))
    shapes = whole_shapes(cfg)
    specs = param_specs(cfg, shapes)
    rep = lint_specs(specs, shapes, axis_sizes)
    if not rep.ok():
        return rep
    for name, splits in held_splits(cfg, shapes).items():
        declared = specs[name]
        if splits != tuple(axis_sizes[a] if a else 1 for a in declared):
            held = _spec_for(splits, declared, axis_sizes)
            rep.add(CHECK, ERROR, name,
                    f"placement declares {declared} but the model holds "
                    f"{held} (split {splits} per dim): fix "
                    f"parallel/sharding.py so that {name!r} is placed "
                    f"{held}, or build the layer sharded {declared} — "
                    f"every reader of the shard (checkpoint, HF import, "
                    f"elastic resize) slices by the declared placement")
    return rep
