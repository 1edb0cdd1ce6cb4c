"""Verified checkpoint lineage of the port (counterpart of
picotron_tpu/ckpt_integrity): commit manifests with per-file digests
(`manifest`), the retention policy behind keep_last / keep_every GC
(`retention`), and the save-dir preflight (`preflight`). Consumers:
checkpoint.CheckpointManager and train.py.
"""

from picotron_tpu_torch.ckpt_integrity.manifest import (
    MANIFEST_NAME, VerifyResult, atomic_write_text, build_manifest,
    file_digest, fsync_dir, verify_step_dir, write_manifest,
)
from picotron_tpu_torch.ckpt_integrity.preflight import (
    checkpoint_nbytes, preflight_save_dir,
)
from picotron_tpu_torch.ckpt_integrity.retention import retention_plan

__all__ = [
    "MANIFEST_NAME", "VerifyResult", "atomic_write_text", "build_manifest",
    "checkpoint_nbytes", "file_digest", "fsync_dir", "preflight_save_dir",
    "retention_plan", "verify_step_dir", "write_manifest",
]
