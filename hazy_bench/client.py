"""The closed-loop client: one caller that sends the next operation when
the last one has returned, through the program's facade
(`ShardedFacade.insert_examples`, `point_labels_of`, `members`). A group
commit is timed from the call until the device has finished its work (a
synchronise after the call: the commit's labels are then maintained); a
read returns host values, so it ends synchronised.

The client keeps what the judge needs: every commit (warm-up too), every
point read's answer with the number of commits before it, and a sample
of the All-Members answers drawn from the seed. With `spans` it also
times `ShardedMultiViewHazy.apply_models` inside each commit and each
reorganization on the device (CUDA events around `_do_reorg`), and with a
profile it labels the calls into each layer with `record_function`
ranges and keeps the windows each kernel launch was given."""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

RANGE = "hazy_bench."
WARM_READS = 256


def _hooks(obj, names):
    """The program's names the traced run wraps: each has to be there and
    callable, or the run stops here, before a per-layer metric can come
    out empty or cover less of the work without a word."""
    missing = [n for n in names if not callable(getattr(obj, n, None))]
    if missing:
        raise RuntimeError(
            f"{type(obj).__name__} has no {missing}: the benchmark's spans "
            f"wrap these names of the program; move them with the program")


class Client:
    def __init__(self, fac, ops, *, members_share: float, seed: int,
                 spans: bool = False):
        self.fac = fac
        self.ops = ops
        self.cuda = fac.driver.device.type == "cuda"
        self.sample = np.random.default_rng([int(seed), 1])
        self.members_share = members_share
        self.commits = []                  # (ids, classes), warm-up too
        self.rows = 0                      # committed in the window
        self.committed = 0                 # committed since the start
        self.lat = {"commit": [], "point": [], "members": []}
        self.points_c, self.points_id, self.points_lab = [], [], []
        self.members = []
        self.apply_s = []                  # with spans: a commit's apply
        self.insert_s = []                 # ... and its whole call
        self.reorg_events = []             # with spans: CUDA events a reorg
        self.ranges = False
        self.launches = []
        self.record = False
        self.spans = spans
        self.slice_from = None
        if spans:
            self._wrap_driver()

    # -- instrumentation (the benchmark's own, around the program's calls)

    def _wrap_driver(self):
        drv = self.fac.driver
        _hooks(drv, ("apply_models", "_do_reorg"))
        apply_models, do_reorg = drv.apply_models, drv._do_reorg

        def timed_apply(*a, **kw):
            t = time.perf_counter()
            with self._range("apply_models"):
                out = apply_models(*a, **kw)
            self.apply_s.append(time.perf_counter() - t)
            return out

        def ranged_reorg(*a, **kw):
            ev = None
            if self.cuda and self.record:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with self._range("reorganize"):
                out = do_reorg(*a, **kw)
            if ev is not None:
                ev[1].record()
                self.reorg_events.append(ev)
            return out

        drv.apply_models, drv._do_reorg = timed_apply, ranged_reorg

    def _range(self, name):
        return (record_function(RANGE + name) if self.ranges
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def launch_windows(self):
        """Keep the (start block, width) tensors each multi-view kernel
        launch receives, with the launch's block and table sizes."""
        from repro_torch.kernels.band_reclassify import ops
        real = ops.kernel
        _hooks(real, ("multiview_band_reclassify",))
        launches = self.launches

        class Proxy:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def multiview_band_reclassify(F, labels, W, b, start_blocks,
                                          widths, *, cap, block_n):
                launches.append((start_blocks, widths, block_n, F.shape[1]))
                return real.multiview_band_reclassify(
                    F, labels, W, b, start_blocks, widths, cap=cap,
                    block_n=block_n)

        ops.kernel = Proxy()
        try:
            yield
        finally:
            ops.kernel = real

    # -- operations

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def step(self, op=None):
        op = next(self.ops) if op is None else op
        kind = op[0]
        if kind == "commit":
            _, ids, classes = op
            with self._range("commit"):
                t = time.perf_counter()
                self.fac.insert_examples(ids, classes)
                t1 = time.perf_counter()
                self._sync()
            dt = time.perf_counter() - t
            self.commits.append((ids, classes))
            self.committed += len(ids)
            if self.record:
                self.lat["commit"].append(dt)
                self.rows += len(ids)
                if self.spans:
                    self.insert_s.append(t1 - t)
        elif kind == "point":
            i = op[1]
            with self._range("point_read"):
                t = time.perf_counter()
                labels, _ = self.fac.point_labels_of(i)
                dt = time.perf_counter() - t
            if self.record:
                self.lat["point"].append(dt)
                self.points_c.append(len(self.commits))
                self.points_id.append(i)
                self.points_lab.append(np.asarray(labels, np.int8))
        else:
            view = op[1]
            with self._range("members"):
                t = time.perf_counter()
                ids = self.fac.members(view)
                dt = time.perf_counter() - t
            if self.record:
                self.lat["members"].append(dt)
                if self.sample.random() < self.members_share:
                    self.members.append((len(self.commits), view,
                                         np.asarray(ids, np.int32)))

    def warmup(self, rows: int, reads: int = WARM_READS):
        """Run the mix until `rows` inserts have been committed; of its
        reads, which change nothing, only the first `reads` of each kind
        run (enough to warm their shapes), the rest are passed over."""
        ran = {"point": 0, "members": 0}
        while self.committed < rows:
            op = next(self.ops)
            if op[0] != "commit":
                if ran[op[0]] >= reads:
                    continue
                ran[op[0]] += 1
            self.step(op)
        self._sync()

    def window(self, seconds: float, profile_s: float = 0.0):
        """Measure for `seconds`. With `profile_s`, the last `profile_s`
        seconds run under the profiler (returned with that slice's host
        seconds; the window runs on until the slice is whole, since the
        profiler takes a while to start); the spans of commits are kept
        only before it."""
        self.apply_s.clear()
        self.record = True
        t0 = time.perf_counter()
        deadline = t0 + seconds
        prof_at = deadline - profile_s
        prof = None
        while time.perf_counter() < deadline:
            if profile_s and prof is None and time.perf_counter() >= prof_at:
                prof, slice_t0 = self._profile_start()
                deadline = max(deadline, slice_t0 + profile_s)
            self.step()
        t1 = time.perf_counter()
        self.record = False
        if self.slice_from is None:
            self.slice_from = self._marks()
        slice_s = None
        if prof is not None:
            self._sync()
            slice_s = time.perf_counter() - slice_t0
            self._profile_stop(prof)
        return t1 - t0, prof, slice_s

    def _activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda
                                         else [])

    def warm_profiler(self):
        """Start and stop the profiler once in set-up: its first start
        takes seconds."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            self._sync()

    def _profile_start(self):
        from torch.profiler import profile
        prof = profile(activities=self._activities())
        self._sync()
        self.slice_from = self._marks()
        self._slice = contextlib.ExitStack()
        self._slice.enter_context(self.launch_windows())
        self.ranges = True
        prof.start()
        return prof, time.perf_counter()

    def _marks(self):
        return {"commit": len(self.lat["commit"]),
                "point": len(self.lat["point"]),
                "members": len(self.lat["members"])}

    def _profile_stop(self, prof):
        prof.stop()
        self.ranges = False
        self._slice.close()

    def outputs(self) -> dict:
        """What the judge compares: the models, every view's labels of
        every row (from `members`, after the window), the reads."""
        fac = self.fac
        k, n = fac.num_views, fac.n
        final = np.full((k, n), -1, np.int8)
        for v in range(k):
            final[v, fac.members(v)] = 1
        return {"W": np.array(fac.W), "b": np.array(fac.b), "final": final,
                "points": {"c": np.asarray(self.points_c, np.int64),
                           "id": np.asarray(self.points_id, np.int64),
                           "labels": np.asarray(self.points_lab, np.int8)
                           .reshape(-1, k)},
                "members": self.members}
