from repro_torch.checkpoint.store import (
    CheckpointCorrupt, all_steps, latest_step, latest_verified_step,
    leaf_crc32, load_checkpoint, load_latest_checkpoint, load_manifest,
    manifest_crcs, save_checkpoint, tree_crcs, verify_checkpoint,
)

__all__ = [
    "CheckpointCorrupt", "all_steps", "latest_step", "latest_verified_step",
    "leaf_crc32", "load_checkpoint", "load_latest_checkpoint",
    "load_manifest", "manifest_crcs", "save_checkpoint", "tree_crcs",
    "verify_checkpoint",
]
