from repro_torch.optim.optimizers import (OptState, apply_updates,
                                          fedprox_grad, sgd)

__all__ = ["OptState", "apply_updates", "fedprox_grad", "sgd"]
