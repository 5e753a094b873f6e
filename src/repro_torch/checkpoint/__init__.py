from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, flatten,
                                         latest_step, load_checkpoint,
                                         save_checkpoint)

__all__ = ["AsyncCheckpointer", "load_checkpoint", "save_checkpoint",
           "latest_step", "flatten"]
