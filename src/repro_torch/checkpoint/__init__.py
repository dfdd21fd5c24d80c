from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore,
    restore_rank,
    save,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "restore_rank", "save"]
