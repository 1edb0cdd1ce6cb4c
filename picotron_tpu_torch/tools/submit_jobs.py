"""Experiment job scheduler of the port (tools/submit_jobs.py ported):
the launcher between `create_config` and `extract_metrics`.

Walks an experiment directory (one subdir per run, each holding a
`config.json` from `python -m picotron_tpu_torch.tools.create_config`)
and drives each job through the reference picotron's `status.txt` state
machine INIT -> PENDING -> RUNNING -> {COMPLETED, FAIL, OOM, TIMEOUT},
with `--only fail|oom|timeout|pending|init` re-filtering and
resubmission and a status table (`--status`).

Launchers:
- `--launcher local` (default): each job is the port's trainer under
  torchrun on this host (`python -m torch.distributed.run --standalone
  --nproc_per_node <dp x tp x pp x cp x ep> -m picotron_tpu_torch.train
  --config <run>/config.json`), its output teed to train.log, the
  outcome classified by exit code and a grep of the log's tail: the
  reference picotron's own greps (`OutOfMemoryError`, "CUDA out of
  memory" and "illegal memory access" are oom; "Timeout", "Timed out"
  and "timed out", the c10d store's among them, are timeout). A config
  with
  `distributed.use_cpu` runs on the CPU (gloo), as the trainer does.
- `--launcher slurm`: renders a batch script per job that starts one
  torchrun per node (`srun --ntasks-per-node=1`, the c10d rendezvous on
  the first node, `--nproc_per_node` the run's world / nodes) and
  submits it with sbatch, optionally chained (`--chain`); `--dry-run`
  renders without submitting, `--watch` polls squeue and flips
  pending -> running.

  python -m picotron_tpu_torch.tools.submit_jobs EXP_DIR
  python -m picotron_tpu_torch.tools.submit_jobs EXP_DIR --only oom
  python -m picotron_tpu_torch.tools.submit_jobs EXP_DIR --launcher slurm \\
      --nodes 2 --dry-run
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STATUSES = ("init", "pending", "running", "completed", "fail", "oom", "timeout")

OOM_PATTERNS = ("OutOfMemoryError", "CUDA out of memory",
                "illegal memory access")
TIMEOUT_PATTERNS = ("Timeout", "Timed out", "timed out")

# The grep alternations are rendered from the same pattern constants the
# local launcher classifies with, so both launchers agree on oom/timeout.
SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node={gpus}
#SBATCH --output={run_dir}/train.log
#SBATCH --time={time_limit}
cd "{repo_root}" || {{ echo fail > "{run_dir}/status.txt"; exit 1; }}
echo running > {run_dir}/status.txt
head=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
srun --ntasks-per-node=1 python -m torch.distributed.run \\
    --nnodes {nodes} --nproc_per_node {gpus} --rdzv_id "$SLURM_JOB_ID" \\
    --rdzv_backend c10d --rdzv_endpoint "$head:29500" \\
    -m picotron_tpu_torch.train --config {run_dir}/config.json
code=$?
if [ $code -eq 0 ]; then echo completed > {run_dir}/status.txt
elif grep -qE '{oom_re}' {run_dir}/train.log; then echo oom > {run_dir}/status.txt
elif grep -qE '{timeout_re}' {run_dir}/train.log; then echo timeout > {run_dir}/status.txt
else echo fail > {run_dir}/status.txt
fi
"""


class Job:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.name = os.path.basename(run_dir.rstrip("/"))
        self.config = os.path.join(run_dir, "config.json")
        self.status_file = os.path.join(run_dir, "status.txt")
        if not os.path.exists(self.status_file):
            self.set_status("init")

    @property
    def status(self) -> str:
        try:
            with open(self.status_file) as f:
                s = f.read().strip().lower()
            return s if s in STATUSES else "init"
        except OSError:
            return "init"

    def set_status(self, s: str) -> None:
        with open(self.status_file, "w") as f:
            f.write(s + "\n")

    def world_size(self) -> int:
        """dp x tp x pp x cp x ep of the run's config (1 for what it
        leaves out)."""
        with open(self.config) as f:
            d = json.load(f).get("distributed", {})
        n = 1
        for axis in ("dp_size", "tp_size", "pp_size", "cp_size", "ep_size"):
            n *= int(d.get(axis, 1))
        return n

    def classify(self, returncode: int) -> str:
        """Exit code + a grep of the log's tail (the reference's
        post-mortem)."""
        if returncode == 0:
            return "completed"
        log_path = os.path.join(self.run_dir, "train.log")
        try:
            with open(log_path, errors="replace") as f:
                f.seek(max(0, os.path.getsize(log_path) - 50_000))
                tail = f.read()
        except OSError:
            tail = ""
        if any(p in tail for p in OOM_PATTERNS):
            return "oom"
        if any(p in tail for p in TIMEOUT_PATTERNS):
            return "timeout"
        return "fail"


def discover_jobs(exp_dir: str) -> list[Job]:
    jobs = []
    for name in sorted(os.listdir(exp_dir)):
        run_dir = os.path.join(exp_dir, name)
        if os.path.isdir(run_dir) and os.path.exists(
                os.path.join(run_dir, "config.json")):
            jobs.append(Job(run_dir))
    return jobs


def local_command(job: Job) -> list[str]:
    """The local launcher's command: the trainer under torchrun, one
    process per rank of the run's layout."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(job.world_size()),
            "-m", "picotron_tpu_torch.train", "--config", job.config]


def run_local(job: Job, timeout: float | None) -> str:
    job.set_status("running")
    log_path = os.path.join(job.run_dir, "train.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        try:
            proc = subprocess.run(local_command(job), stdout=log,
                                  stderr=subprocess.STDOUT, cwd=REPO_ROOT,
                                  timeout=timeout)
            status = job.classify(proc.returncode)
        except subprocess.TimeoutExpired:
            status = "timeout"
    job.set_status(status)
    print(f"  {job.name}: {status} ({time.time() - t0:.0f}s)")
    return status


def render_slurm(job: Job, nodes: int, time_limit: str) -> str:
    """Render the job's batch script to <run_dir>/job.slurm and return the
    path: one torchrun per node over the run's world / nodes GPUs."""
    world = job.world_size()
    if world % nodes:
        raise ValueError(f"{job.name}: world size {world} does not divide "
                         f"over {nodes} nodes")
    script = os.path.join(job.run_dir, "job.slurm")
    with open(script, "w") as f:
        f.write(SLURM_TEMPLATE.format(
            name=job.name, nodes=nodes, gpus=world // nodes,
            run_dir=os.path.abspath(job.run_dir), time_limit=time_limit,
            repo_root=REPO_ROOT, oom_re="|".join(OOM_PATTERNS),
            timeout_re="|".join(TIMEOUT_PATTERNS)))
    return script


def submit_slurm(job: Job, nodes: int, time_limit: str,
                 depend_on: str | None) -> str | None:
    script = render_slurm(job, nodes, time_limit)
    cmd = ["sbatch", "--parsable"]
    if depend_on:
        cmd.append(f"--dependency=afterany:{depend_on}")
    cmd.append(script)
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        print(f"  {job.name}: sbatch failed: {out.stderr.strip()}")
        job.set_status("fail")
        return None
    job.set_status("pending")
    job_id = out.stdout.strip().split(";")[0]
    print(f"  {job.name}: submitted as {job_id}")
    return job_id


def watch_queue(exp_dir: str, job_ids: dict[str, str], interval: float = 30.0,
                max_polls: int | None = None) -> None:
    """Poll squeue and flip each submitted job's status.txt pending ->
    running when SLURM starts it; a job that leaves the queue while still
    pending (killed before its script's first line) is marked fail. A
    failing squeue is retried, and after 5 failures in a row the watcher
    stops and leaves status.txt to the scripts' own epilogues. Returns
    when every watched job has left the queue."""
    watched = dict(job_ids)  # name -> slurm job id
    polls = 0
    consecutive_failures = 0
    while watched and (max_polls is None or polls < max_polls):
        out = subprocess.run(
            ["squeue", "--noheader", "--format=%i %T",
             "--jobs", ",".join(watched.values())],
            capture_output=True, text=True)
        if out.returncode != 0:
            consecutive_failures += 1
            if consecutive_failures >= 5:
                print(f"  watch: squeue failing persistently "
                      f"({out.stderr.strip()[:120]}); stopping the watcher "
                      f"for {sorted(watched)}")
                return
            polls += 1
            time.sleep(interval)
            continue
        consecutive_failures = 0
        states = {}
        for line in out.stdout.splitlines():
            parts = line.split()
            if len(parts) >= 2:
                states[parts[0]] = parts[1]
        for name, jid in list(watched.items()):
            job = Job(os.path.join(exp_dir, name))
            st = states.get(jid)
            if st == "RUNNING" and job.status == "pending":
                job.set_status("running")
            elif st is None:
                if job.status == "pending":
                    job.set_status("fail")
                del watched[name]
        polls += 1
        if watched:
            time.sleep(interval)


def print_table(jobs: list[Job]) -> None:
    counts: dict[str, int] = {}
    width = max((len(j.name) for j in jobs), default=4)
    print(f"{'run'.ljust(width)}  status")
    for j in jobs:
        s = j.status
        counts[s] = counts.get(s, 0) + 1
        print(f"{j.name.ljust(width)}  {s}")
    print("--")
    print("  ".join(f"{k}:{v}" for k, v in sorted(counts.items())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="picotron-tpu job scheduler "
                                 "(PyTorch port)")
    ap.add_argument("exp_dir")
    ap.add_argument("--launcher", choices=["local", "slurm"], default="local")
    ap.add_argument("--only", choices=list(STATUSES), default=None,
                    help="resubmit only jobs currently in this status")
    ap.add_argument("--status", action="store_true",
                    help="print the status table and exit")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--time-limit", default="02:00:00")
    ap.add_argument("--job-timeout", type=float, default=None,
                    help="per-job wall-clock limit for the local launcher (s)")
    ap.add_argument("--chain", action="store_true",
                    help="chain slurm jobs with --dependency=afterany")
    ap.add_argument("--dry-run", action="store_true",
                    help="slurm launcher only: render each job's batch "
                         "script to <run_dir>/job.slurm and print it "
                         "without submitting (status.txt untouched)")
    ap.add_argument("--watch", action="store_true",
                    help="slurm launcher only: after submitting, poll "
                         "squeue and flip status.txt pending -> running")
    ap.add_argument("--watch-interval", type=float, default=30.0)
    args = ap.parse_args(argv)
    if args.dry_run and args.launcher != "slurm":
        ap.error("--dry-run renders sbatch scripts; use with "
                 "--launcher slurm")

    jobs = discover_jobs(args.exp_dir)
    if not jobs:
        print(f"no runs with config.json under {args.exp_dir}")
        return 0
    if args.status:
        print_table(jobs)
        return 0

    if args.only:
        jobs = [j for j in jobs if j.status == args.only]
    else:
        # default: everything not already completed or in flight
        jobs = [j for j in jobs if j.status in ("init", "fail", "oom",
                                                "timeout")]
    print(f"{len(jobs)} job(s) to run")

    prev_id = None
    submitted: dict[str, str] = {}
    for job in jobs:
        if args.launcher == "local":
            run_local(job, args.job_timeout)
        elif args.dry_run:
            script = render_slurm(job, args.nodes, args.time_limit)
            print(f"  {job.name}: rendered {script}")
            with open(script) as f:
                print("    | " + f.read().rstrip().replace("\n", "\n    | "))
        else:
            new_id = submit_slurm(job, args.nodes, args.time_limit,
                                  prev_id if args.chain else None)
            if new_id is not None:
                # a failed submission keeps the previous anchor, so later
                # jobs stay chained
                prev_id = new_id
                submitted[job.name] = new_id

    if args.watch and submitted:
        watch_queue(args.exp_dir, submitted, interval=args.watch_interval)
    print_table(discover_jobs(args.exp_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
