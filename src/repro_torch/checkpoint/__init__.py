"""Checkpoints in the reference's on-disk format (port of
``repro/checkpoint``): blocking save/restore with a sha256 index, the
async manager, and the fault injectors of ``checkpoint.faults``."""
from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointError,
    gc_steps,
    gc_tmp_dirs,
    latest_step,
    latest_verified_step,
    load_meta,
    restore,
    save,
    verify,
)
from repro_torch.checkpoint.manager import AsyncCheckpointManager  # noqa: F401
