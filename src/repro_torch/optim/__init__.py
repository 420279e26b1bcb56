from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          momentum_sgd, sgd)
from repro_torch.optim.schedule import (constant, cosine_decay,
                                        linear_warmup_cosine)

__all__ = ["Optimizer", "adam", "momentum_sgd", "sgd", "apply_updates",
           "global_norm", "clip_by_global_norm", "constant", "cosine_decay",
           "linear_warmup_cosine"]
