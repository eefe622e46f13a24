from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    latest_step,
    read_manifest,
    restore_tree,
    save_tree,
)
