"""Time edited copies of the flash-attention source against the source
itself, on the card:

    python -m picotron_tpu_torch.kernels.variants --kernel flash_bwd_dq \
        --variant 'ns3:int DQ_NS = 2;=>int DQ_NS = 3;' \
        [--variant ...] [--rounds 3]

Each --variant is NAME:OLD=>NEW, with more OLD=>NEW pairs joined by ";;":
exact substrings of csrc/flash_attention.cu, each of which must occur
(every occurrence is replaced). The source ("base") and every variant are
built at once, one nvcc each, into build/variants/, and the ptxas lines of
the kernel's tensor-core function (the D-64 wgmma one) are printed. At chip_smoke's training
shape and its GQA D 128 shape, each build is held to the plain version
(the worst row of each of the kernel's outputs, printed beside
chip_smoke's limit and not enforced: a variant may trade accuracy) and
timed by CUDA events with and without RoPE (the forward's and the
dk/dv's time with RoPE at D 64 holds the rotation pre-pass; the D-64 dq
is timed on the rotated q and k, as the backward shares them), in turns (base, variants,
repeated --rounds times) so that all share the card's state. The last
line is one JSON object. Needs a CUDA card; run it from the repository
root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from picotron_tpu_torch.kernels import build

# the public counter name of each kernel -> its tensor-core function
FUNCTIONS = {"flash_fwd": "fwd_wgmma_kernel",
             "flash_bwd_dq": "bwd_dq_wgmma_kernel",
             "flash_bwd_dkv": "bwd_dkv_wgmma_kernel"}


def edit(source: str, spec: str) -> tuple[str, str]:
    """(name, edited source) of a NAME:OLD=>NEW[;;OLD=>NEW...] spec."""
    name, _, edits = spec.partition(":")
    for pair in edits.split(";;"):
        old, sep, new = pair.partition("=>")
        if not name or not sep or old not in source:
            raise ValueError(f"variant {spec!r}: want NAME:OLD=>NEW with OLD "
                             f"in the source")
        source = source.replace(old, new)
    return name, source


def ptxas_lines(log: str, function: str) -> list[str]:
    """nvcc -Xptxas -v lines about the entry functions whose name holds
    `function`."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = function in line
        if keep:
            lines.append(line.strip())
    return lines


def _build(name: str, source: str):
    out_dir = build.BUILD_DIR / "variants" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_attention.cu"
    src.write_text(source)
    lib = out_dir / "libflash_attention.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=list(FUNCTIONS), required=True)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("variants: needs a CUDA card")
    import chip_smoke
    from picotron_tpu_torch.ops import flash_attention as fa
    from picotron_tpu_torch.ops.rope import rope_tables

    base = (build.CSRC / "flash_attention.cu").read_text()
    sources = dict([("base", base)] + [edit(base, s) for s in args.variant])
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build, sources, sources.values())))
    libs = {}
    for name, (path, log) in built.items():
        for line in ptxas_lines(log, FUNCTIONS[args.kernel]):
            print(f"{name} ptxas: {line}")
        libs[name] = ctypes.CDLL(str(path))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {name: {} for name in libs}
    dev = torch.device("cuda")
    for i, (label, shp) in enumerate(list(chip_smoke.SHAPES.items())[:2]):
        case = chip_smoke.make_case(fa, rope_tables, *shp, dev=dev, seed=i)
        q, k, v, qpos, kpos, tabs, do, dlse, static = case
        for name, lib in libs.items():
            build._LIBS["flash_attention"] = lib
            for key, (kname, rows, *_) in chip_smoke.kernel_errors(
                    fa, case).items():
                if kname == args.kernel:
                    res[name][f"{label} {key} worst row"] = float(rows.max())
        flops = chip_smoke.bounds(*shp)[args.kernel][2]
        for rope, t in (("", tabs), (" without RoPE", None)):
            out, lse = fa.fwd_plain(q, k, v, qpos, kpos, t, True)
            delta = fa._delta(do, out, dlse)
            wg = t is not None and fa._wgmma(q)
            q_rot, k_rot = ((fa.rope_rows(q, *t[:2]), fa.rope_rows(k, *t[2:]))
                            if wg else (q, k))
            fn = {
                "flash_fwd": lambda: fa.fwd_kernel(q, k, v, qpos, kpos, t,
                                                   True, static),
                "flash_bwd_dq": lambda: fa.bwd_dq_kernel(
                    q_rot, k_rot, v, do, lse, delta, qpos, kpos, t, True,
                    static, wg),
                "flash_bwd_dkv": lambda: fa.bwd_dkv_kernel(
                    q, k, v, do, lse, delta, qpos, kpos, t, True, static),
            }[args.kernel]
            times = {name: [] for name in libs}
            for _ in range(args.rounds):
                for name, lib in libs.items():
                    build._LIBS["flash_attention"] = lib
                    times[name].append(chip_smoke.cuda_ms(fn, iters=20,
                                                          warmup=3))
            for name, ts in times.items():
                ms = statistics.median(ts)
                res[name][label + rope] = ms
                print(f"{name} {args.kernel} {label}{rope} ({card}): "
                      f"{ms:.4f} ms (median of {args.rounds}: {ts}), "
                      f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del case, q, k, v, do, out, lse, delta, q_rot, k_rot
        torch.cuda.empty_cache()
    build._LIBS.pop("flash_attention", None)
    for name, r in res.items():
        rows = {k: x for k, x in r.items() if k.endswith("worst row")}
        limit = {k: chip_smoke.LSE_ATOL if " lse " in k else
                 chip_smoke.ROW_RTOL for k in rows}
        over = [k for k, x in rows.items() if not x <= limit[k]]
        print(f"{name}: {rows}" + (f", OVER THE LIMIT: {over}" if over
                                   else ""))
    out = {"card": card, "kernel": args.kernel, "variants": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
