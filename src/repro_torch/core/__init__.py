"""The port's maintenance core; exports what `repro.core` exports.

Layer 1 rules, Layer 2's `EngineParams` and `EngineState` (its pure steps
are in `core.engine`) and the host helpers are imported here. The engine shells,
views and facades import the kernels, whose plain versions import
`core.engine`; so they are exported lazily, loaded on first access
(`from repro_torch.core import HazyEngine`), and importing a kernel module
first cannot run into a half-initialized one."""
import importlib

from repro_torch.core.linear_model import (LinearModel, zero_model, sgd_step,
                                           train_batch, full_gradient_train,
                                           precision_recall, torch_sgd_step)
from repro_torch.core.engine import (EngineParams, EngineState, band_mask,
                                     band_partition, band_windows, classify,
                                     covering_windows, hot_buffer_window,
                                     probe_partition, row_norms,
                                     skiing_charge, skiing_due,
                                     waters_bounds, waters_update)
from repro_torch.core.waters import Waters, eps_bounds, holder_M, vector_norm
from repro_torch.core.skiing import (Skiing, alpha_star, opt_cost,
                                     skiing_schedule)
from repro_torch.core.random_features import RandomFeatures

_LAZY = {
    "HazyEngine": "hazy", "NaiveEngine": "hazy",
    "MultiViewEngine": "multiview",
    "ClassificationView": "view",
    "MulticlassView": "multiclass", "sgd_all_views": "multiclass",
    "EngineFacade": "facade", "SingleViewFacade": "facade",
    "DerivedViewFacade": "facade", "MultiViewFacade": "facade",
    "ShardedFacade": "facade", "make_sharded_facade": "facade",
}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"repro_torch.core.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
