"""Checkpointing of the port (counterpart of picotron_tpu/checkpoint.py):
train-state save/resume with commit manifests, params-only restore, and
HF safetensors import/export.

Layout, the JAX package's with a torch payload in place of Orbax's:

    <save_dir>/step_%08d/
        state/params.pt      fp32 master params {name: tensor}; under
                              optimizer_offload the bf16 compute copy
        state/opt_state.pt   {"mu": {name: tensor}, "nu": {...}, "count",
                              "step"}: moments in their dtype (bf16 stays
                              bf16), AdamW's count, TrainState.step; under
                              optimizer_offload also "master" {name: fp32}
        meta.json            step, trained_tokens, config, dataloader
        manifest.json        per-file sizes and digests + topology

Durability: the payload is written under `state.tmp.<pid>/`, fsynced, and
renamed to `state/` last; a step dir whose `state/` exists is durable.
The manifest is written after the rename; `latest_valid_step` trusts a
step only when it is durable AND verifies against its manifest. Two
chaos points (resilience/chaos.py) sit on this path: `ckpt_save` inside
the retried payload write (`ckpt_io` raises there), and
`ckpt_committed` after the manifest commits (the corruption kinds flip a
byte in, or truncate, the largest file under `state/`, or tear
meta.json, which verification then catches).

Async saves (`checkpoint.async_save`, the default): `save()` returns once
every tensor has been copied to host memory. The port updates params and
moments in place, so a writer that read device tensors after `save()`
returned would save a later step; the host copies are the snapshot (under
offload the pinned master and moments are copied host to host, as the
next step overwrites them in place). A checkpoint of the other
optimizer_offload mode is refused, naming the option. The
file write, manifest hash and retention GC then run on a thread that
`wait_until_finished` joins (and re-raises a failed payload write from).

Restore reads with `torch.load(weights_only=True, mmap=True)` and copies
into the live tensors, so it costs no second device copy. A checkpoint
of another model shape is refused, naming both. A topology change goes
through `resilience/elastic.check_restore_topology`, as in the JAX
package: tp/cp/ep refused, dp/pp refused naming the `elastic_resize`
re-stamp unless `checkpoint.elastic` is on, and then only at a constant
global batch; an uneven pp split whose layer slots differ is refused
(`elastic.check_pp_slots`).

Under a parallel layout (`par`, the rank's `mesh.ParallelEnv`) each rank
writes its own shards and no rank gathers the model: the ranks at dp 0
and cp 0 write `params.rank<R>.pt` (their tp shards, and under expert
parallelism their ep shard of the MoE banks; the other dp and cp ranks
hold copies), and each rank writes `opt_state.rank<R>.pt` under ZeRO-1
(its rows of the moments and, under offload, of the master), else the
ranks at dp 0 and cp 0 do. All write into one shared `state.tmp/`; after the
ranks agree on the checkpoint's gloo group that every write landed, rank
0 renames it to `state/` and writes the manifest, which covers every
rank's files, and the ranks agree again before `wait_until_finished`
returns. The topology records the layout's sizes (ep included), zero1 and the
process count.
A rank of the same layout reads its own files; when the files lie
otherwise (another dp or pp under `checkpoint.elastic`, ZeRO-1 toggled,
or saved with a process group and restored without one, or the other
way round) each rank regathers its (ep, tp) coordinate's tensors whole
from the saved files and keeps its own stage's tensors and ZeRO-1 rows
(`elastic.read_whole`), the re-split that replaces Orbax's reshard.
Rank 0 picks the step to restore and the others take its answer.

HF safetensors (Llama/Qwen2 families, and Mixtral's MoE names:
`block_sparse_moe.gate` the router, `experts.<j>.{w1,w3,w2}` expert j's
gate, up and down projections): the port's [out, in] weight layout is
HF's own, so nothing is transposed but the MoE router and banks, which
keep the JAX [in, out] layout. The format (an 8-byte
little-endian header length, a JSON header of dtype/shape/data_offsets,
then the raw bytes) is read and written here, without the `safetensors`
package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import struct
import sys
import threading
import time
import warnings
from typing import Optional, Union

import torch
import torch.distributed as dist

from picotron_tpu_torch.ckpt_integrity import (
    MANIFEST_NAME, VerifyResult, atomic_write_text, build_manifest,
    fsync_dir, retention_plan, verify_step_dir, write_manifest,
)
from picotron_tpu_torch.config import Config, ModelConfig
from picotron_tpu_torch.resilience import chaos, elastic
from picotron_tpu_torch.resilience.retry import RetryPolicy, retry_call
from picotron_tpu_torch.telemetry import bus as telemetry_bus
from picotron_tpu_torch.train_step import TrainState

PARAMS_FILE = elastic.PARAMS_FILE
OPT_FILE = elastic.OPT_FILE


def topology(cfg: Config, par=None) -> dict:
    """The parallel layout a checkpoint is saved under (the slice count
    past one slice); under a process group (`par`) also its process count
    and whether ZeRO-1 shards the optimizer state."""
    d = cfg.distributed
    topo = {"dp": d.dp_size, "pp": d.pp_size, "ep": d.ep_size,
            "cp": d.cp_size, "tp": d.tp_size, "world_size": d.world_size,
            "process_count": 1}
    if d.slices > 1:
        topo["slices"] = d.slices
    if par is not None:
        topo.update(process_count=par.world_size, zero1=bool(d.zero1))
    return topo


_rank_file = elastic.rank_file


def _agree(ok: bool, par) -> bool:
    """True on every rank iff `ok` is True on every rank (the checkpoint's
    gloo group: host-side, never queued behind the model's collectives)."""
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=par.host_group)
    return bool(flag.item())


def _from_rank0(obj, par):
    """Rank 0's `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=par.host_group)
    return box[0]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`, complete when this returns (a CUDA->CPU copy
    without non_blocking waits for the device)."""
    return t.detach().to("cpu", copy=True)


def _save_file(obj, path: str) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _load_file(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


class CheckpointManager:
    """Save/restore a TrainState under `<save_dir>/step_<n>/`, with commit
    manifests, lineage fallback past corrupt steps, and retention GC
    (`checkpoint.keep_last` / `keep_every`), which never deletes the last
    verified step. `timings` holds the seconds of the last save's host
    copy (`snapshot_s`), payload write (`write_s`) and manifest hash
    (`manifest_s`), and of the last restore's verification (`verify_s`)
    and load (`load_s`). `par`: the rank's ParallelEnv under a layout
    (every rank then makes the same calls: saves and restores agree over
    the ranks)."""

    def __init__(self, cfg: Config, directory: Optional[str] = None,
                 par=None):
        self.cfg = cfg
        self.par = par
        self.directory = os.path.abspath(directory or cfg.checkpoint.save_dir)
        self._commit_thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.timings: dict = {}
        # Flaky-store retry (resilience config). The manifest commit keeps
        # the attempt budget with short delays.
        self._retry = RetryPolicy.from_config(cfg.resilience)
        self._probe_retry = dataclasses.replace(
            self._retry,
            base_delay=min(self._retry.base_delay, 0.2),
            max_delay=min(self._retry.max_delay, 1.0))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # -- save -------------------------------------------------------------

    def save(self, state: TrainState, trained_tokens: int = 0,
             dataloader_state: Optional[dict] = None) -> str:
        """Snapshot `state` to host memory, write meta.json, and commit
        the payload + manifest (on a thread when async_save). Returns the
        step dir."""
        # At most one save in flight.
        self.wait_until_finished()
        step = int(state.step)
        path = self._step_dir(step)
        t0 = time.perf_counter()
        model, opt = state.model, state.optimizer
        par = self.par
        first = par is None or par.bank_rank == 0
        params = opt_state = None
        if first:
            params = {n: _host(p) for n, p in model.named_parameters()}
        opt.synchronize()
        if first or self.cfg.distributed.zero1:
            opt_state = {kind: {n: _host(t) for n, t in tensors.items()}
                         for kind, tensors in opt.state_tensors().items()}
            opt_state.update(count=int(opt.count), step=step)
        self.timings = {"snapshot_s": time.perf_counter() - t0}
        meta = {"step": step, "trained_tokens": int(trained_tokens),
                "config": self.cfg.to_json_dict()}
        if dataloader_state is not None:
            meta["dataloader"] = dict(dataloader_state)

        def _write_meta():
            os.makedirs(path, exist_ok=True)
            atomic_write_text(os.path.join(path, "meta.json"),
                              json.dumps(meta, indent=2))

        if par is None:
            retry_call(_write_meta, policy=self._retry,
                       describe=f"checkpoint meta write (step {step})")
        elif par.is_main:
            ok = False
            try:
                retry_call(_write_meta, policy=self._retry,
                           describe=f"checkpoint meta write (step {step})")
                tmp = os.path.join(path, "state.tmp")
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp)
                ok = True
            finally:
                _agree(ok, par)
        elif not _agree(True, par):
            raise RuntimeError(f"checkpoint step {step}: rank 0 could not "
                               f"write {path}")
        if self.cfg.checkpoint.async_save:
            self._commit_thread = threading.Thread(
                target=self._commit_async, args=(step, path, params,
                                                 opt_state),
                name=f"ckpt-commit-{step}", daemon=False)
            self._commit_thread.start()
        else:
            self._commit(step, path, params, opt_state)
        return path

    def _write_payload(self, path: str, params: dict, opt_state: dict,
                       step: int):
        """state.tmp.<pid>/ -> fsync -> rename to state/ (replacing a
        stale payload of the same step, whose manifest goes first). The
        chaos point `ckpt_save` sits inside this retried write, so an
        injected store failure costs a backoff, not the run."""
        chaos.fire("ckpt_save", step=step)
        tmp = os.path.join(path, f"state.tmp.{os.getpid()}")
        final = os.path.join(path, "state")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _save_file(params, os.path.join(tmp, PARAMS_FILE))
        _save_file(opt_state, os.path.join(tmp, OPT_FILE))
        fsync_dir(tmp)
        stale_manifest = os.path.join(path, MANIFEST_NAME)
        if os.path.exists(stale_manifest):
            os.remove(stale_manifest)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        fsync_dir(path)

    def _write_rank_files(self, tmp: str, params, opt_state,
                          step: int) -> None:
        """This rank's files of a layout's checkpoint into the shared
        `tmp` dir, fsynced (with the `ckpt_save` chaos point, as
        `_write_payload`)."""
        chaos.fire("ckpt_save", step=step)
        os.makedirs(tmp, exist_ok=True)
        for kind, obj in (("params", params), ("opt_state", opt_state)):
            if obj is not None:
                _save_file(obj, os.path.join(
                    tmp, _rank_file(kind, self.par.rank)))

    def _commit_ranks(self, step: int, path: str, params, opt_state) -> None:
        """A layout's payload: every rank writes its files, the ranks agree
        that all landed, rank 0 renames the shared dir into place, and the
        ranks agree again (raises on every rank if any part failed)."""
        tmp = os.path.join(path, "state.tmp")
        err = None
        try:
            retry_call(self._write_rank_files, tmp, params, opt_state,
                       step, policy=self._retry,
                       describe=f"checkpoint save (step {step})")
        except Exception as e:  # noqa: BLE001 — raised after agreeing
            err = e
        if not _agree(err is None, self.par):
            raise err or RuntimeError(
                f"checkpoint step {step}: another rank failed to write "
                f"its files; the step is not durable")
        if self.par.is_main:
            try:
                final = os.path.join(path, "state")
                fsync_dir(tmp)
                stale_manifest = os.path.join(path, MANIFEST_NAME)
                if os.path.exists(stale_manifest):
                    os.remove(stale_manifest)
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                fsync_dir(path)
            except Exception as e:  # noqa: BLE001 — raised after agreeing
                err = e
        if not _agree(err is None, self.par):
            raise err or RuntimeError(
                f"checkpoint step {step}: rank 0 could not commit {path}")

    def _commit(self, step: int, path: str, params: dict,
                opt_state: dict) -> None:
        """Write the payload (raises on failure: the step is then not
        durable), then the manifest and GC (a failure there leaves the
        step durable-but-legacy, reported as an event, not raised; under
        a layout they are rank 0's)."""
        t0 = time.perf_counter()
        if self.par is None:
            retry_call(self._write_payload, path, params, opt_state, step,
                       policy=self._retry,
                       describe=f"checkpoint save (step {step})")
        else:
            self._commit_ranks(step, path, params, opt_state)
        t1 = time.perf_counter()
        self.timings["write_s"] = t1 - t0
        del params, opt_state
        if self.par is not None and not self.par.is_main:
            return
        try:
            def _hash_and_write():
                manifest = build_manifest(
                    path, step=step, topology=topology(self.cfg, self.par))
                write_manifest(path, manifest)
                return manifest

            manifest = retry_call(
                _hash_and_write, policy=self._probe_retry,
                describe=f"manifest commit (step {step})")
            self.timings["manifest_s"] = time.perf_counter() - t1
            telemetry_bus.emit("ckpt_commit", step=step,
                               files=manifest["file_count"],
                               bytes=manifest["total_bytes"])
            # Corruption chaos mutates the *committed* bytes: the fault
            # the manifest machinery exists to catch.
            chaos.fire("ckpt_committed", step=step, path=path)
            self.gc()
        except Exception as e:  # noqa: BLE001
            self._probe_failed(path, e, what="manifest commit")

    def _commit_async(self, *args) -> None:
        try:
            self._commit(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised on join
            self._error = e

    def wait_until_finished(self) -> None:
        """Block until an in-flight async save is durable AND its manifest
        is written; re-raise a failed payload write. Call before exit and
        before restoring a checkpoint this manager may still be writing."""
        t = self._commit_thread
        if t is not None and t is not threading.current_thread():
            t.join()
            self._commit_thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    @staticmethod
    def _probe_failed(path: str, e: Exception,
                      what: str = "durability probe") -> bool:
        telemetry_bus.emit("ckpt_probe_failed", what=what, path=str(path),
                           error=repr(e))
        warnings.warn(f"checkpoint {what} failed for {path}: {e!r}")
        return False

    # -- lineage ----------------------------------------------------------

    def _is_durable(self, step: int) -> bool:
        """True when the step's payload was renamed into place (a
        layout's shared dir is renamed only after every rank's files
        landed)."""
        state_dir = os.path.join(self._step_dir(step), "state")
        if not os.path.isdir(state_dir):
            return False
        names = os.listdir(state_dir)
        return (any(n.startswith("params.rank") for n in names)
                or (PARAMS_FILE in names and OPT_FILE in names))

    def steps(self) -> list:
        """All step numbers with a step_<n> dir, sorted (durable or not)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for d in os.listdir(self.directory)
                      if (m := re.fullmatch(r"step_(\d+)", d)))

    def durable_steps(self) -> list:
        return [s for s in self.steps() if self._is_durable(s)]

    def latest_step(self) -> Optional[int]:
        """Newest *durable* step (not content-verified; prefer
        latest_valid_step)."""
        steps = self.durable_steps()
        return max(steps) if steps else None

    def verify_step(self, step: int, deep: bool = True) -> VerifyResult:
        return verify_step_dir(self._step_dir(step), deep=deep)

    def _report_corrupt(self, step: int, res: VerifyResult) -> None:
        telemetry_bus.emit("ckpt_corrupt", step=step,
                           failures=list(res.failures[:8]))
        print(f"[ckpt] step {step} failed verification "
              f"({'; '.join(res.failures[:3]) or res.status}); "
              f"falling back to an older checkpoint",
              file=sys.stderr, flush=True)

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that is durable AND verifies against its manifest:
        what restore, auto-resume and rollback trust. Each corrupt step
        skipped on the way down emits `ckpt_corrupt`. Under a layout it is
        rank 0's answer on every rank."""
        if self.par is not None:
            self.wait_until_finished()  # the commit thread's group
            return _from_rank0(self._latest_valid_step()
                               if self.par.is_main else None, self.par)
        return self._latest_valid_step()

    def _latest_valid_step(self) -> Optional[int]:
        for step in sorted(self.durable_steps(), reverse=True):
            res = self.verify_step(step)
            if res.ok:
                return step
            self._report_corrupt(step, res)
        return None

    def valid_steps(self) -> list:
        return [s for s in self.durable_steps() if self.verify_step(s).ok]

    def gc(self, dry_run: bool = False) -> dict:
        """Retention GC over durable steps per keep_last / keep_every;
        returns {"kept", "deleted"}. The last verified step is protected:
        keep_last=1 with a corrupt newest step keeps the fallback alive."""
        ck = self.cfg.checkpoint
        if ck.keep_last <= 0:
            return {"kept": self.steps(), "deleted": []}
        last_valid = self._latest_valid_step()
        keep, delete = retention_plan(
            self.durable_steps(), keep_last=ck.keep_last,
            keep_every=ck.keep_every,
            protect=() if last_valid is None else (last_valid,))
        if not dry_run:
            for s in delete:
                shutil.rmtree(self._step_dir(s))
            if delete:
                telemetry_bus.emit("ckpt_gc", deleted=delete, kept=keep)
        return {"kept": keep, "deleted": delete}

    # -- restore ----------------------------------------------------------

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> tuple[TrainState, dict]:
        """Restore into `state`'s tensors in place; returns (state, meta),
        meta carrying trained_tokens and the dataloader position. With no
        step: the newest durable AND verified one (lineage fallback). An
        explicit step is validated the same way first, so a non-durable or
        corrupt request fails with the list of valid steps."""
        self.wait_until_finished()  # never read our own partial write
        t0 = time.perf_counter()
        if step is None:
            step = self.latest_valid_step()
            if step is None:
                raise FileNotFoundError(
                    f"no valid checkpoints under {self.directory}")
        else:
            if not self._is_durable(step):
                raise FileNotFoundError(
                    f"checkpoint step {step} under {self.directory} is "
                    f"missing or not durable (save incomplete/crashed); "
                    f"available valid steps: {self.valid_steps()}")
            res = self.verify_step(step)
            if not res.ok:
                self._report_corrupt(step, res)
                raise FileNotFoundError(
                    f"checkpoint step {step} under {self.directory} failed "
                    f"verification ({'; '.join(res.failures[:3])}); "
                    f"available valid steps: {self.valid_steps()}")
        verify_s = time.perf_counter() - t0
        out = self.load_step(state, step)
        self.timings["verify_s"] = verify_s
        return out

    def load_step(self, state: TrainState,
                  step: int) -> tuple[TrainState, dict]:
        """Load one step into `state` without verifying it (restore and
        the trainer's auto-resume verify first)."""
        t0 = time.perf_counter()
        path = self._step_dir(step)

        def _read_json(name):
            with open(os.path.join(path, name)) as f:
                return json.load(f)

        meta = retry_call(_read_json, "meta.json", policy=self._retry,
                          describe=f"checkpoint meta read (step {step})")
        resize = elastic.check_restore_topology(
            path, meta, self.cfg, step=step, save_dir=self.directory)
        if resize is not None:
            # for the caller (train.build_state books and emits it);
            # never written back to disk
            meta["elastic_resize"] = resize
        elastic.check_pp_slots(meta, self.cfg)
        state_dir = os.path.join(path, "state")
        src = elastic.step_layout(state_dir, elastic.saved_topology(path),
                                  meta)
        dst = elastic.FileLayout.of_config(self.cfg, self.par is not None)

        def load(p):
            return retry_call(_load_file, p, policy=self._retry,
                              describe=f"checkpoint restore (step {step})")

        if src == dst:
            params_file, opt_file = PARAMS_FILE, OPT_FILE
            if self.par is not None:
                # the tp (and ep) shards of this rank's dp 0, cp 0 peer;
                # the optimizer state is this rank's own under ZeRO-1
                src_rank = self.par.rank_at(dp=0, cp=0)
                params_file = _rank_file("params", src_rank)
                opt_file = _rank_file("opt_state", self.par.rank
                                      if self.cfg.distributed.zero1
                                      else src_rank)
            params = load(os.path.join(state_dir, params_file))
            opt_state = load(os.path.join(state_dir, opt_file))
        else:
            params, opt_state = self._share_of(state, state_dir, src, load)
        model, opt = state.model, state.optimizer
        named = list(model.named_parameters())
        live = opt.state_tensors()
        saved, wanted = "master" in opt_state, "master" in live
        if saved != wanted:
            raise ValueError(
                f"checkpoint step {step} under {self.directory} was saved "
                f"with training.optimizer_offload "
                f"{'on' if saved else 'off'}; this run has it "
                f"{'on' if wanted else 'off'}. Set "
                f"training.optimizer_offload as the checkpoint was saved")
        _check_shapes(params, {n: p for n, p in named}, "param", step)
        for kind, tensors in live.items():
            _check_shapes(opt_state[kind], tensors, f"AdamW {kind}", step)
        with torch.no_grad():
            for n, p in named:
                p.copy_(params[n])
                for kind, tensors in live.items():
                    tensors[n].copy_(opt_state[kind][n])
        dev = next(model.parameters()).device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        opt.count = int(opt_state["count"])
        state.step = int(opt_state["step"])
        self.timings["load_s"] = time.perf_counter() - t0
        return state, meta

    def _share_of(self, state: TrainState, state_dir: str,
                  src: "elastic.FileLayout", load) -> tuple[dict, dict]:
        """This rank's params and optimizer state out of files written in
        another layout: its (ep, tp) coordinate regathered whole, then its
        stage's tensors and its ZeRO-1 rows (`opt.rows`)."""
        par, opt = self.par, state.optimizer
        coord = (0, 0) if par is None else (par.ep_rank, par.tp_rank)
        whole = elastic.read_whole(state_dir, src, [coord], load)[coord]
        names = [n for n, _ in state.model.named_parameters()]
        params = {n: whole["params"][n] for n in names
                  if n in whole["params"]}
        opt_state = {kind: {n: opt.rows(i, tensors[n])
                            for i, n in enumerate(names) if n in tensors}
                     for kind, tensors in whole["opt"].items()}
        opt_state.update(count=whole["count"], step=whole["step"])
        return params, opt_state


def _check_shapes(saved: dict, live: dict, what: str, step: int) -> None:
    """Raise ValueError naming both sides when the saved tensors' names,
    shapes or dtypes differ from the live model's."""
    diffs = []
    for n in sorted(set(saved) | set(live)):
        s, t = saved.get(n), live.get(n)
        sd = None if s is None else (tuple(s.shape), s.dtype)
        td = None if t is None else (tuple(t.shape), t.dtype)
        if sd != td:
            diffs.append(f"{n}: saved {sd} vs this run's {td}")
    if diffs:
        raise ValueError(
            f"checkpoint step {step} holds a different model ({what}s): "
            + "; ".join(diffs[:4])
            + (f"; and {len(diffs) - 4} more" if len(diffs) > 4 else ""))


def restore_params_only(cfg: Config, ckpt_dir: str,
                        step: Optional[int] = None,
                        dtype: Optional[torch.dtype] = None
                        ) -> tuple[dict, int]:
    """Only the params of a training checkpoint ({name: CPU tensor}, the
    whole model's state_dict; cast to `dtype` when given) and the step:
    the generation/export path. Reads the params files alone, never the
    moments; under optimizer_offload, whose params files hold the bf16
    compute copy, the fp32 master of the optimizer files instead
    (memory-mapped: the moments are not read), as the JAX package's
    restore_params_only. A parallel layout's per-rank files are read
    whole: the union of the pp stages, the tp shards concatenated along
    their split dims (a "row" tp strategy's flipped ones under `cfg`),
    the ep shards of the MoE banks along the expert dim. With no step:
    the newest durable AND verified one."""
    from picotron_tpu_torch.parallel.sharding import (
        ep_shard_dim, tp_flips, tp_shard_dim,
    )

    mgr = CheckpointManager(cfg, directory=ckpt_dir)
    if step is None:
        step = mgr.latest_valid_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints under {ckpt_dir}")
    path = mgr._step_dir(step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state_dir = os.path.join(path, "state")
    layout = elastic.step_layout(state_dir, elastic.saved_topology(path),
                                 meta)
    whole = elastic.read_whole(state_dir, layout)
    if cfg.training.optimizer_offload:
        if "master" not in whole[(0, 0)]["opt"]:
            raise ValueError(
                f"checkpoint step {step} under {ckpt_dir} was saved with "
                f"training.optimizer_offload off; this config has it on")
        parts = {c: w["opt"]["master"] for c, w in whole.items()}
    else:
        parts = {c: w["params"] for c, w in whole.items()}
    size = layout.size
    flips = tp_flips(cfg)
    params = {}
    for n in elastic.order_names(parts[(0, 0)]):
        tpd, epd = tp_shard_dim(n, flips), ep_shard_dim(n)
        banks = []
        for e in range(size["ep"] if epd is not None else 1):
            shards = [parts[(e, t)][n] for t in range(
                size["tp"] if tpd is not None else 1)]
            banks.append(shards[0] if len(shards) == 1
                         else torch.cat(shards, dim=tpd))
        t = banks[0] if len(banks) == 1 else torch.cat(banks, dim=epd)
        params[n] = t.to(dtype) if dtype is not None else t.clone()
    return params, step


# ---------------------------------------------------------------------------
# HF safetensors
# ---------------------------------------------------------------------------

# HF name suffix under model.layers.<i>. -> the port's layer param
_LAYER_MAP = {
    "self_attn.q_proj.weight": "q",
    "self_attn.k_proj.weight": "k",
    "self_attn.v_proj.weight": "v",
    "self_attn.o_proj.weight": "o",
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_norm",
    "mlp.gate_proj.weight": "gate",
    "mlp.up_proj.weight": "up",
    "mlp.down_proj.weight": "down",
}
# Mixtral's MoE names: block_sparse_moe.experts.<j>.{w1,w2,w3} hold expert
# j's gate/down/up projections, block_sparse_moe.gate is the router
_MOE_EXPERT_MAP = {"w1": "w_gate", "w2": "w_down", "w3": "w_up"}
# Qwen2-style qkv bias
_BIAS_MAP = {
    "self_attn.q_proj.bias": "b_q",
    "self_attn.k_proj.bias": "b_k",
    "self_attn.v_proj.bias": "b_v",
}
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """All tensors of one .safetensors file, as CPU tensors."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES[info["dtype"]]
            start, end = info["data_offsets"]
            if end == start:
                out[name] = torch.empty(info["shape"], dtype=dtype)
                continue
            f.seek(base + start)
            buf = bytearray(f.read(end - start))
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(
                info["shape"])
    return out


def write_safetensors(tensors: dict[str, torch.Tensor], path: str,
                      metadata: Optional[dict] = None) -> None:
    """Write `tensors` as one .safetensors file (names sorted, data packed
    without gaps, header padded with spaces to 8 bytes), via a tmp name
    and a rename."""
    header, offset, items = {}, 0, []
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
        items.append(t)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hb += b" " * (-len(hb) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for t in items:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_safetensors_dir(path: str) -> dict[str, torch.Tensor]:
    """Single-file or index-sharded HF safetensors checkpoint dir."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    single_path = os.path.join(path, "model.safetensors")
    tensors: dict[str, torch.Tensor] = {}
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        for shard in sorted(set(index["weight_map"].values())):
            tensors.update(read_safetensors(os.path.join(path, shard)))
    elif os.path.exists(single_path):
        tensors.update(read_safetensors(single_path))
    else:
        raise FileNotFoundError(
            f"no model.safetensors[.index.json] under {path}")
    return tensors


def load_hf_safetensors(path: str, cfg: ModelConfig,
                        dtype: torch.dtype = torch.float32) -> dict:
    """An HF Llama-family (or Mixtral) safetensors checkpoint as the
    port's state_dict ({name: CPU tensor}, fp32 by default; load with
    `model.load_state_dict`)."""
    raw = _read_safetensors_dir(path)
    nl = cfg.num_hidden_layers
    file_layers = {int(m.group(1)) for k in raw
                   if (m := re.match(r"model\.layers\.(\d+)\.", k))}
    if file_layers and len(file_layers) != nl:
        raise ValueError(
            f"checkpoint at {path} has {len(file_layers)} layers but the "
            f"config expects num_hidden_layers={nl}; pass a matching model "
            f"config")

    def get(name: str) -> torch.Tensor:
        if name not in raw:
            raise KeyError(f"tensor {name!r} missing from checkpoint "
                           f"(found {len(raw)} tensors)")
        return raw[name].to(dtype)

    lmap = {k: v for k, v in _LAYER_MAP.items()
            if not (cfg.num_experts and k.startswith("mlp."))}
    if cfg.attention_bias:
        lmap.update(_BIAS_MAP)
    sd = {"embedding": get("model.embed_tokens.weight"),
          "final_norm": get("model.norm.weight")}
    for i in range(nl):
        for suffix, key in lmap.items():
            sd[f"layers.{i}.{key}"] = get(f"model.layers.{i}.{suffix}")
        if cfg.num_experts:
            moe = f"model.layers.{i}.block_sparse_moe."
            sd[f"layers.{i}.router"] = get(moe + "gate.weight").t()
            for short, key in _MOE_EXPERT_MAP.items():
                sd[f"layers.{i}.{key}"] = torch.stack([
                    get(f"{moe}experts.{j}.{short}.weight").t()
                    for j in range(cfg.num_experts)]).contiguous()
    if not cfg.tie_word_embeddings:
        # a tied-head file loaded as an untied model: untie by copying
        sd["lm_head"] = (get("lm_head.weight") if "lm_head.weight" in raw
                         else sd["embedding"].clone())
    return sd


def save_hf_safetensors(params: Union[torch.nn.Module, dict],
                        path: str) -> None:
    """Export the port's params (a model or its state_dict) to HF Llama
    (and Mixtral) naming in `<path>/model.safetensors`, at the params'
    dtype."""
    sd = (dict(params.named_parameters())
          if isinstance(params, torch.nn.Module) else params)
    os.makedirs(path, exist_ok=True)
    inv = {v: k for k, v in {**_LAYER_MAP, **_BIAS_MAP}.items()}
    moe_inv = {v: k for k, v in _MOE_EXPERT_MAP.items()}
    out = {}
    for name, t in sd.items():
        if name == "embedding":
            out["model.embed_tokens.weight"] = t
        elif name == "final_norm":
            out["model.norm.weight"] = t
        elif name == "lm_head":
            out["lm_head.weight"] = t
        else:
            m = re.fullmatch(r"layers\.(\d+)\.(\w+)", name)
            key = None if m is None else m.group(2)
            moe = f"model.layers.{m.group(1)}.block_sparse_moe." if m else ""
            if key == "router":
                out[moe + "gate.weight"] = t.t().contiguous()
            elif key in moe_inv:
                for j in range(t.shape[0]):
                    out[f"{moe}experts.{j}.{moe_inv[key]}.weight"] = (
                        t[j].t().contiguous())
            elif key in inv:
                out[f"model.layers.{m.group(1)}.{inv[key]}"] = t
            else:
                raise KeyError(f"no HF name for param {name!r}")
    write_safetensors(out, os.path.join(path, "model.safetensors"))
