from repro_torch.optim.optimizers import (adamw_init, adamw_update, sgd_update,
                                          clip_by_global_norm, global_norm,
                                          opt_specs, tree_leaves,
                                          tree_unflatten)
from repro_torch.optim.schedules import warmup_cosine, constant
