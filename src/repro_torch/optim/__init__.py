from repro_torch.optim.optim import (adamw, init_opt, make_optimizer,
                                     opt_update, sgd, sgdm)
