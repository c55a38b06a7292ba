from repro_torch.optim.optimizers import (OptState, adamw, apply_updates,
                                          fedprox_grad, sgd)

__all__ = ["OptState", "adamw", "apply_updates", "fedprox_grad", "sgd"]
