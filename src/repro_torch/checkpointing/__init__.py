from repro_torch.checkpointing.checkpoint import (latest_checkpoint,
                                                  load_checkpoint,
                                                  load_flat_checkpoint,
                                                  save_checkpoint,
                                                  save_flat_checkpoint,
                                                  tree_digest)

__all__ = ["load_checkpoint", "save_checkpoint", "latest_checkpoint",
           "load_flat_checkpoint", "save_flat_checkpoint", "tree_digest"]
