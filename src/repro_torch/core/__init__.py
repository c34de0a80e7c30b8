"""The port's maintenance core. Layer 1 rules and host helpers are
re-exported here; the device engines and the facade, which import the
kernels, live in `repro_torch.core.sharded` and `repro_torch.core.facade`
(the kernels' plain versions import `core.engine`)."""
from repro_torch.core.linear_model import (LinearModel, zero_model, sgd_step,
                                           train_batch, full_gradient_train,
                                           precision_recall, torch_sgd_step)
from repro_torch.core.engine import (band_mask, band_partition, classify,
                                     covering_windows, probe_partition,
                                     row_norms, skiing_charge, skiing_due,
                                     waters_bounds, waters_update)
from repro_torch.core.waters import Waters, eps_bounds, holder_M, vector_norm
from repro_torch.core.skiing import Skiing, alpha_star
from repro_torch.core.multiclass import sgd_all_views
