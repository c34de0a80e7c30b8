"""The port's invariant tooling: the runtime lock-order witness
(`repro_torch.analysis.witness`, armed by `REPRO_LOCK_WITNESS=1`), the
counterpart of `repro.analysis.witness`.

The static passes stay in `repro.analysis`, which scans the port's tree
too (`python -m repro.analysis src/repro_torch`); none of them is ported
here. This package stays light: `repro_torch.storage` imports the witness
on its construction paths."""
from repro_torch.analysis.witness import (LOCK_ORDER, REENTRANT,
                                          LockOrderError, WitnessedLock,
                                          assert_unlocked, enabled, wrap)

__all__ = ["LOCK_ORDER", "REENTRANT", "LockOrderError", "WitnessedLock",
           "assert_unlocked", "enabled", "wrap"]
