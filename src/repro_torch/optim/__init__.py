from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                         chain_clip_by_global_norm, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                        linear_decay, wsd)

__all__ = ["Optimizer", "adam", "adamw", "sgd", "chain_clip_by_global_norm",
           "constant", "linear_decay", "cosine_decay", "wsd"]
