from .checkpointer import (latest_step, load_checkpoint, restore_sharded,
                           save_checkpoint)

__all__ = ["latest_step", "load_checkpoint", "restore_sharded",
           "save_checkpoint"]
