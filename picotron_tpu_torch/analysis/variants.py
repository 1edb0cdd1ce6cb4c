"""Input-signature prover — one signature per program, certified before
any run (port of picotron_tpu/analysis/variants.py).

In JAX every jit entry point compiles anew whenever the abstract
signature of a call changes (a leaf's shape, dtype, sharding or
commitment), silently. The port compiles nothing on these paths, so a
"variant" here is a change in a program's input signature: a leaf's
(path, shape, dtype, device). It is the discipline that capturing a
program as a CUDA graph needs (a graph replays fixed addresses of fixed
shapes on one device), and a tensor on the host joining a device
program is the counterpart of JAX's "uncommitted" array: every call
copies it over, and a captured graph cannot read it.

- `signature_of(tree)` canonicalises one call's signature
  (`AbstractSig`): per leaf (path, shape, dtype, device).
- `audit_feeds(feeds, device=)` enumerates the signatures a call site
  can produce: more than one is an error, a leaf off the program's
  device a warning.
- `prove_train_step(cfg)` certifies the training step: the state's
  signature after one recorded step (`analysis/trace.py`, on meta)
  equals the one before, and every leaf lies on the step's device.
- `prove_mpmd_stages(cfg)` certifies the pipeline's boundary exchanges:
  every send and receive of a stage has one signature, and the schedule
  table passes its lint.
- `prove_serve_programs` / `prove_disagg_programs` build the serving
  engines' program inputs from the config alone (on meta): every shape
  is a function of (model config, serve config), request identity is
  data. `check_engine_feed(engine)` checks a live engine: every
  persistent input (the parameters and buffers, the KV pool, the rope
  tables) on its pool's device; every per-step upload goes through the
  engine's `_up`, to the engine's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from picotron_tpu_torch.analysis.report import ERROR, INFO, WARNING, Report

CHECK = "variants"


@dataclass(frozen=True)
class AbstractSig:
    """One call's canonical input signature."""

    treedef: str
    leaves: tuple    # ((path, shape, dtype, device), ...)

    def diff(self, other: "AbstractSig") -> list:
        """Human-readable component differences vs `other`."""
        out = []
        if self.treedef != other.treedef:
            out.append("structure differs")
        a = {leaf[0]: leaf[1:] for leaf in self.leaves}
        b = {leaf[0]: leaf[1:] for leaf in other.leaves}
        for path in sorted(set(a) | set(b)):
            if path not in a or path not in b:
                out.append(f"{path}: leaf only on one side")
                continue
            for name, x, y in zip(("shape", "dtype", "device"), a[path],
                                  b[path]):
                if x != y:
                    out.append(f"{path}: {name} {x!r} vs {y!r}")
        return out


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of nested dicts, lists and tuples ('a/0/b')."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix or "<root>": tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _leaf_sig(path: str, x) -> tuple:
    if isinstance(x, torch.Tensor):
        return (path, tuple(x.shape), str(x.dtype), x.device.type)
    return (path, (), type(x).__name__, "host")


def signature_of(tree) -> AbstractSig:
    """The `AbstractSig` of one call's arguments."""
    flat = flatten(tree)
    return AbstractSig(repr([(p, type(x).__name__) for p, x in flat.items()]),
                       tuple(_leaf_sig(p, x) for p, x in flat.items()))


def _off_device(sig: AbstractSig, device: str) -> list:
    return [leaf for leaf in sig.leaves
            if leaf[3] != device and leaf[3] != "host"]


def audit_feeds(feeds, *, entry: str = "<program>",
                device: str = None) -> Report:
    """The signature space of a call site's possible feeds: more than one
    signature is an error (the program's inputs are not fixed), a tensor
    leaf off `device` (default: the first feed's first tensor's) a
    warning."""
    rep = Report()
    sigs = [signature_of(tree) for tree in feeds]
    if device is None:
        device = next((leaf[3] for s in sigs for leaf in s.leaves
                       if leaf[3] != "host"), "host")
    for s in sigs:
        for path, shape, dtype, dev in _off_device(s, device):
            rep.add(CHECK, WARNING, f"{entry}/{path}",
                    f"feed can be on {dev} ({dtype}{list(shape)}) where "
                    f"the program runs on {device}: every call copies it "
                    f"over, and a program captured as a CUDA graph "
                    f"cannot read it — place it on {device} up front")
    uniq = []
    for s in sigs:
        if s not in uniq:
            uniq.append(s)
    if len(uniq) > 1:
        diffs = uniq[0].diff(uniq[1])
        rep.add(CHECK, ERROR, entry,
                f"{len(uniq)} distinct input signatures reach this program "
                f"— one signature is NOT provable. First divergence: "
                f"{'; '.join(diffs[:4])}")
    rep.info[CHECK] = {"entry": entry, "feeds": len(feeds),
                       "signatures": len(uniq),
                       "proven": len(uniq) <= 1 and rep.ok()}
    return rep


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def prove_train_step(cfg, *, recorded=None) -> Report:
    """Certify the training step keeps one signature: for every recorded
    rank, the state's leaves after the step have the signature they had
    before it, and every leaf lies on the step's device."""
    from picotron_tpu_torch.analysis.trace import state_snapshot

    if recorded is None:
        from picotron_tpu_torch.analysis.trace import record_train_step

        recorded = record_train_step(cfg)
    rep = Report()
    n_leaves = off = 0
    for rank in sorted(recorded.states):
        before = recorded.before[rank]
        after = state_snapshot(recorded.states[rank])
        n_leaves += len(before)
        for name, (_, _, shape, dtype, dev, _) in before.items():
            # optimizer_offload keeps the optimizer state in host memory
            host_ok = (cfg.training.optimizer_offload
                       and name.split("/")[0] in ("master", "mu", "nu"))
            if dev != recorded.device and not host_ok:
                off += 1
                rep.add(CHECK, ERROR, name,
                        f"train-step state leaf on {dev}, the step on "
                        f"{recorded.device}: every step copies it over")
            new = after.get(name)
            if new is None or new[2:5] != (shape, dtype, dev):
                got = "gone" if new is None else f"{new[3]}{list(new[2])}"
                rep.add(CHECK, ERROR, name,
                        f"steady-state signature differs from the initial "
                        f"one ({dtype}{list(shape)} in, {got} out): step 2 "
                        f"presents a new input signature")
    ids, tgt = recorded.batch
    batch_sig = signature_of({"ids": ids, "targets": tgt})
    proven = rep.ok()
    rep.info[CHECK] = {
        "entry": "train_step",
        "signatures": 1 if proven else 2,
        "proven": proven,
        "leaves": n_leaves + len(batch_sig.leaves),
        "uncommitted": off,
        "covers": ("train_step", "fused-bwd interior", "pp interior"),
    }
    if proven:
        rep.add(CHECK, INFO, "train_step",
                f"one input signature proven: {n_leaves} state leaves "
                f"keep shape, dtype and device across the step")
    return rep


def prove_mpmd_stages(cfg, *, recorded=None) -> Report:
    """Certify the pipeline's stage boundaries: each stage's sends and
    receives present one signature (shape, dtype) per direction, and the
    schedule table passes `parallel/mpmd.lint_schedule`."""
    from picotron_tpu_torch.parallel.mpmd import build_schedule, lint_schedule

    if recorded is None:
        from picotron_tpu_torch.analysis.trace import record_train_step

        recorded = record_train_step(cfg)
    rep = Report()
    entries = {}
    for rank in sorted(recorded.programs):
        by_role: dict = {}
        for op in recorded.programs[rank]:
            if op.kind == "collective_permute":
                by_role.setdefault(op.role, set()).add((op.shape, op.dtype))
        for role, sigs in sorted(by_role.items()):
            entry = f"stage_rank{rank}_{role}"
            entries[entry] = {"signatures": len(sigs),
                              "proven": len(sigs) == 1}
            if len(sigs) > 1:
                rep.add(CHECK, ERROR, entry,
                        f"{len(sigs)} signatures cross this stage boundary "
                        f"({sorted(sigs)[:3]}): the exchange's buffers "
                        f"are not one shape")
    pl, d = cfg.pipeline, cfg.distributed
    n_micro = cfg.training.gradient_accumulation_steps
    kind = pl.schedule if pl.executor == "mpmd" else "1f1b"
    table = build_schedule(kind, n_micro, d.pp_size, pl.interleave
                           if pl.executor == "mpmd" else 1)
    problems = lint_schedule(table, n_micro, d.pp_size,
                             pl.interleave if pl.executor == "mpmd" else 1,
                             kind=kind)
    for p in problems:
        rep.add(CHECK, ERROR, "schedule", p)
    lint = {"kind": kind, "ops": len(table),
            "ticks": (max(op.tick for op in table) + 1) if table else 0,
            "problems": len(problems), "proven": not problems}
    proven = rep.ok()
    rep.info[CHECK] = {"entry": "mpmd_stages", "programs": len(entries),
                       "proven": proven, "entries": entries,
                       "schedule_lint": lint}
    if proven:
        rep.add(CHECK, INFO, "mpmd_stages",
                f"one signature per stage boundary for all "
                f"{len(entries)} stage exchange(s) (schedule {kind})")
    return rep


# ---------------------------------------------------------------------------
# Serve programs
# ---------------------------------------------------------------------------


def _engine_pools(engine) -> list:
    """(pool name, device, {input: tree}) of an engine's persistent inputs:
    the decode pool's, and the prefill pool's of a disaggregated one."""
    pools = [("decode", engine.device,
              {"model": dict(engine.model.state_dict(keep_vars=True)),
               "k": engine._k, "v": engine._v, "cos": engine.cos,
               "sin": engine.sin})]
    if getattr(engine, "device_p", None) is not None:
        pools.append(("prefill", engine.device_p,
                      {"model": dict(engine.model_p.state_dict(
                          keep_vars=True)),
                       "k": engine._k_p, "v": engine._v_p,
                       "cos": engine.cos_p, "sin": engine.sin_p}))
    return pools


def check_engine_feed(engine) -> Report:
    """Certify a live serving engine's programs: every persistent input
    on its pool's device (a host tensor there is copied on every dispatch
    and cannot sit in a captured graph), per-step uploads through
    `engine._up` to the engine's device (true by construction: it is the
    engines' only upload path; recorded here)."""
    rep = Report()
    off = []
    leaves = 0
    for pool, dev, tree in _engine_pools(engine):
        for path, leaf in flatten(tree).items():
            leaves += 1
            if isinstance(leaf, torch.Tensor) and leaf.device != dev:
                off.append(f"{pool}/{path}")
                rep.add(CHECK, WARNING, f"{pool}/{path}",
                        f"persistent serve input on {leaf.device} where "
                        f"the {pool} pool runs on {dev}: every dispatch "
                        f"copies it, and a decode captured as a CUDA "
                        f"graph cannot read it — place the model with "
                        f"generate.place_for_decode (or .to({dev})) "
                        f"before building the engine")
    proven = not off
    rep.info[CHECK] = {
        "entry": "serve_decode+prefill",
        "signatures": 1 if proven else 2,
        "proven": proven,
        "uncommitted": off,
        "leaves": leaves,
        "upload_device": str(engine.device),
        "slots": getattr(engine, "num_slots", None),
    }
    if proven:
        rep.add(CHECK, INFO, "serve",
                f"one input signature proven for decode and prefill: "
                f"{leaves} persistent inputs on their pools' devices; "
                f"uploads go to {engine.device}; the slot count is the "
                f"only static shape")
    return rep


def _program_inputs(model_cfg, scfg, slots: int, num_blocks: int,
                    max_blocks: int) -> tuple:
    """(k, v) of a pool and the int64 vector maker, on meta."""
    from picotron_tpu_torch.serve.paged_cache import init_paged_cache

    cache = init_paged_cache(model_cfg, num_blocks, scfg.block_size, slots,
                             max_blocks, device="meta")
    return cache.k, cache.v


def _i64(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int64, device="meta")


def prove_serve_programs(model_cfg, serve_cfg=None, *, params=None,
                         device: str = "cuda") -> Report:
    """Engine-less proof for a config's decode and prefill programs: their
    inputs built as `ServeEngine` feeds them, every shape a function of
    (model config, serve config). With `params` ({name: tensor}), a
    parameter off `device` is flagged (place it with
    `generate.place_for_decode`)."""
    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.serve.scheduler import blocks_for

    scfg = serve_cfg or ServeConfig()
    scfg.validate()
    rep = Report()
    max_len = scfg.max_model_len or model_cfg.max_position_embeddings
    max_blocks = blocks_for(max_len, scfg.block_size)
    num_blocks = scfg.num_blocks or scfg.decode_slots * max_blocks
    s = scfg.decode_slots
    k, v = _program_inputs(model_cfg, scfg, s, num_blocks, max_blocks)
    decode = {"k": k, "v": v, "tables": _i64(s, max_blocks), "toks": _i64(s),
              "positions": _i64(s), "rids": _i64(s), "tidx": _i64(s)}
    prefill = {"k": k, "v": v, "tables": _i64(s, max_blocks),
               "chunk_ids": _i64(s, scfg.prefill_chunk),
               "start_pos": _i64(s), "n_valid": _i64(s), "rids": _i64(s),
               "tidx": _i64(s)}
    sig_d, sig_p = signature_of(decode), signature_of(prefill)
    off = []
    if params is not None:
        want = torch.device(device).type
        off = [p for p, leaf in flatten(params).items()
               if isinstance(leaf, torch.Tensor)
               and leaf.device.type != want]
        for p in off:
            rep.add(CHECK, WARNING, f"params/{p}",
                    f"serve params leaf is not on {device}: place the "
                    f"model with generate.place_for_decode (or .to()) "
                    f"before building the engine")
    proven = not off
    rep.info[CHECK] = {
        "entry": "serve_decode+prefill",
        "signatures": 1 if proven else 2,
        "proven": proven,
        "decode_leaves": len(sig_d.leaves),
        "prefill_leaves": len(sig_p.leaves),
        "uncommitted": off,
    }
    return rep


def prove_disagg_programs(model_cfg, serve_cfg=None) -> Report:
    """Engine-less proof for the disaggregated engine's four programs
    (serve/disagg.py): the prefill pool's chunk, the decode pool's step
    and the handoff's gather and scatter. Pool sizes, slot counts and the
    handoff's [max_blocks] index width are config constants; request
    identity, positions, tables and the handoff's block ids are data, so
    each program has one signature. MoE models are refused, as the
    engine refuses them."""
    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.serve.scheduler import blocks_for

    scfg = serve_cfg or ServeConfig()
    scfg.validate()
    if model_cfg.num_experts:
        raise ValueError(
            "disaggregated serving rejects MoE models (chunked-prefill "
            "expert routing is not parity-guaranteed)")
    rep = Report()
    max_len = scfg.max_model_len or model_cfg.max_position_embeddings
    max_blocks = blocks_for(max_len, scfg.block_size)
    s = scfg.decode_slots
    p = scfg.prefill_slots or s
    dk, dv = _program_inputs(model_cfg, scfg, s,
                             scfg.num_blocks or s * max_blocks, max_blocks)
    pk, pv = _program_inputs(model_cfg, scfg, p,
                             scfg.prefill_num_blocks or p * max_blocks,
                             max_blocks)
    decode = {"k": dk, "v": dv, "tables": _i64(s, max_blocks),
              "toks": _i64(s), "positions": _i64(s), "rids": _i64(s),
              "tidx": _i64(s)}
    if scfg.speculator == "ngram":
        from picotron_tpu_torch.serve.spec_decode import CTX_W

        decode["ctx"] = _i64(s, CTX_W)
    prefill = {"k": pk, "v": pv, "tables": _i64(p, max_blocks),
               "chunk_ids": _i64(p, scfg.prefill_chunk),
               "start_pos": _i64(p), "n_valid": _i64(p), "rids": _i64(p),
               "tidx": _i64(p)}
    gather = {"k": pk, "v": pv, "idx": _i64(max_blocks)}
    scatter = {"k": dk, "v": dv, "idx": _i64(max_blocks)}
    sigs = {"prefill_pool": signature_of(prefill),
            "decode_pool": signature_of(decode),
            "handoff_gather": signature_of(gather),
            "handoff_scatter": signature_of(scatter)}
    rep.info[CHECK] = {
        "entry": "serve_disagg",
        "programs": len(sigs),
        "signatures": {name: len(sig.leaves) for name, sig in sigs.items()},
        "proven": True,
        "prefill_slots": p, "decode_slots": s,
        "speculator": scfg.speculator,
    }
    rep.add(CHECK, INFO, "serve_disagg",
            f"one input signature proven for both pools + handoff: "
            f"{len(sigs)} programs (prefill [{p}, {scfg.prefill_chunk}], "
            f"decode [{s}], handoff idx [{max_blocks}])")
    return rep


def audit_variants(cfg, *, recorded=None) -> Report:
    """The `variants` check: the train-step proof, the stage boundaries'
    under the mpmd executor, and the serving programs' of the config's
    model (the JAX check's parts)."""
    rep = prove_train_step(cfg, recorded=recorded)
    info = {"train_step": rep.info.get(CHECK, {})}
    if cfg.pipeline.executor == "mpmd":
        stage_rep = prove_mpmd_stages(cfg, recorded=recorded)
        rep.findings.extend(stage_rep.findings)
        info["mpmd_stages"] = stage_rep.info.get(CHECK, {})
    serve_rep = prove_serve_programs(cfg.model)
    rep.findings.extend(serve_rep.findings)
    info["serve"] = serve_rep.info.get(CHECK, {})
    try:
        disagg_rep = prove_disagg_programs(cfg.model, cfg.serve)
        rep.findings.extend(disagg_rep.findings)
        info["serve_disagg"] = disagg_rep.info.get(CHECK, {})
    except ValueError as e:  # MoE models: disagg serving refuses them
        info["serve_disagg"] = {"unavailable": str(e)}
    rep.info[CHECK] = info
    return rep
