"""Export a training checkpoint of the port to an HF safetensors directory
(the port's copy of tools/export_hf.py):

    python -m picotron_tpu_torch.tools.export_hf --config cfg.json \
        --ckpt-dir ckpt --out exported_hf [--step N]

Reads only the params (`checkpoint.restore_params_only`: a parallel
layout's per-rank files read whole; under optimizer_offload the fp32
master) and writes the HF Llama/Qwen2/Mixtral names
(`checkpoint.save_hf_safetensors`), which `load_hf_safetensors`,
`init_from_hf` and `generate --hf-dir` read back. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

from picotron_tpu_torch.checkpoint import (
    restore_params_only, save_hf_safetensors,
)
from picotron_tpu_torch.config import load_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="picotron-tpu port -> HF export")
    ap.add_argument("--config", required=True,
                    help="training config JSON of the run")
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint save_dir of the run")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: newest verified)")
    ap.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    params, step = restore_params_only(cfg, args.ckpt_dir, step=args.step)
    save_hf_safetensors(params, args.out)
    print(f"exported step {step} -> "
          f"{os.path.join(args.out, 'model.safetensors')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
