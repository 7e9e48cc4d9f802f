from repro_torch.optim.optimizers import Optimizer, adam, adamw, sgd
from repro_torch.optim.schedules import constant, linear_decay

__all__ = ["Optimizer", "adam", "adamw", "sgd", "constant", "linear_decay"]
