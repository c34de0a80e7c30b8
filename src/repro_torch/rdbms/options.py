"""Typed WITH-option schemas for the DDL/ALTER surface.

Every `WITH (...)` option the dialect accepts is declared ONCE here as an
`OptionSpec` (value type, default, choices, whether `ALTER VIEW ... SET`
may change it). The parser, `Catalog.create_view`, `ALTER VIEW ... SET`
and the facade constructors all consume the same parsed dataclass —
there is exactly one place a new DDL option gets added, one coercion per
value type, and one error message that lists the valid options.

Value kinds:

  int / float / str    plain scalars (the lexer delivers numbers as
                       floats and bare identifiers/strings as str)
  flag                 on/off | true/false | 1/0
  choice               one of `spec.choices`
  budget               memory budget: a fraction in (0, 1] of the entity
                       table's bytes, or an absolute byte count (> 1)
  lag                  a freshness target: '5 s' / '500 ms' / '2 m' (a
                       quoted duration), a bare number of seconds, or
                       `downstream` (derive the lag from consumer views)

`target_lag` values parse to float seconds, the `DOWNSTREAM` sentinel, or
None (no lag declared: the view is maintained at commit time, exactly the
pre-scheduler behavior).
"""
from __future__ import annotations

import dataclasses
import re
from math import isfinite
from typing import Any, Dict, Optional, Tuple

from repro_torch.rdbms.ast_nodes import PlanError

#: `target_lag = downstream`: the view's lag is derived from its consumers.
DOWNSTREAM = "downstream"

_LAG_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*(ms|s|m|h)?\s*$")
_LAG_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}

_TRUE = ("on", "true", "1", "1.0")
_FALSE = ("off", "false", "0", "0.0")


def coerce_number(value: float):
    """The dialect's single number coercion: integral floats become ints
    (the lexer produces floats; `k = 3` must arrive as the int 3)."""
    if isfinite(value) and value == int(value):
        return int(value)
    return value


def parse_lag(value) -> Optional[object]:
    """'5 s' / '500 ms' / bare seconds / 'downstream' -> seconds | sentinel."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        seconds = float(value)
    else:
        text = str(value).strip().lower()
        if text in ("downstream",):
            return DOWNSTREAM
        m = _LAG_RE.match(text)
        if not m:
            raise PlanError(
                f"bad target_lag {value!r}: want a duration like '5 s', "
                f"'500 ms', '2 m', a bare number of seconds, or downstream")
        seconds = float(m.group(1)) * _LAG_UNITS[m.group(2)]
    if seconds <= 0:
        raise PlanError(f"target_lag must be positive, got {value!r}")
    return seconds


def format_lag(lag) -> str:
    if lag is None:
        return "-"
    if lag == DOWNSTREAM:
        return "downstream"
    if lag < 1.0:
        return f"{lag * 1e3:g} ms"
    return f"{lag:g} s"


@dataclasses.dataclass(frozen=True)
class OptionSpec:
    name: str
    kind: str                       # int | float | str | flag | choice | budget | lag
    default: Any = None
    choices: Tuple[str, ...] = ()
    alterable: bool = False         # may ALTER VIEW ... SET change it?

    def coerce(self, value):
        try:
            if self.kind == "int":
                v = int(value)
                if v != float(value):
                    raise ValueError
                return v
            if self.kind == "float":
                return float(value)
            if self.kind == "str":
                return str(value)
            if self.kind == "flag":
                text = str(value).lower()
                if text in _TRUE:
                    return True
                if text in _FALSE:
                    return False
                raise ValueError
            if self.kind == "choice":
                text = str(value).lower()
                if text not in self.choices:
                    raise PlanError(
                        f"option {self.name} must be one of "
                        f"{'/'.join(self.choices)}, got {value!r}")
                return text
            if self.kind == "budget":
                v = float(value)
                if v <= 0:
                    raise PlanError(
                        f"option {self.name} must be positive (a fraction "
                        f"in (0, 1] of the entity table, or bytes)")
                return v
            if self.kind == "lag":
                return parse_lag(value)
        except PlanError:
            raise
        except (TypeError, ValueError):
            pass
        raise PlanError(f"option {self.name} wants a {self.kind}, "
                       f"got {value!r}")


class _OptionSchema:
    """Shared parse/validate machinery for one statement's option set."""

    specs: Dict[str, OptionSpec] = {}
    what = "option"

    @classmethod
    def parse(cls, raw: Optional[dict]):
        raw = dict(raw or {})
        unknown = set(raw) - set(cls.specs)
        if unknown:
            raise PlanError(
                f"unknown {cls.what}s: {sorted(unknown)}; valid {cls.what}s "
                f"are {', '.join(sorted(cls.specs))}")
        fields = {name: spec.coerce(raw[name]) if name in raw else spec.default
                  for name, spec in cls.specs.items()}
        return cls(**fields)

    def alter(self, raw: dict):
        """A new options object with the ALTER-able subset of `raw`
        applied; non-alterable options raise (they shape the engine at
        construction time and cannot be changed in place)."""
        raw = dict(raw or {})
        unknown = set(raw) - set(self.specs)
        if unknown:
            raise PlanError(
                f"unknown {self.what}s: {sorted(unknown)}; valid {self.what}s "
                f"are {', '.join(sorted(self.specs))}")
        frozen = [k for k in raw if not self.specs[k].alterable]
        if frozen:
            alterable = sorted(k for k, s in self.specs.items()
                               if s.alterable)
            raise PlanError(
                f"option(s) {sorted(frozen)} cannot be changed by ALTER "
                f"(they fix the engine at CREATE); alterable options are "
                f"{alterable}")
        changed = {k: self.specs[k].coerce(v) for k, v in raw.items()}
        return dataclasses.replace(self, **changed)


_VIEW_SPECS = [
    OptionSpec("policy", "choice", "eager", ("eager", "lazy", "hybrid")),
    OptionSpec("k", "int", None),
    OptionSpec("engine", "choice", None, ("hazy", "multiview", "sharded")),
    OptionSpec("buffer_frac", "float", None),
    OptionSpec("p", "float", 2.0),
    OptionSpec("q", "float", 2.0),
    OptionSpec("alpha", "float", 1.0),
    OptionSpec("lr", "float", 0.1),
    OptionSpec("l2", "float", 1e-4),
    OptionSpec("cost_mode", "choice", "measured", ("measured", "modeled")),
    OptionSpec("touch_ns", "float", 0.0),
    OptionSpec("cap_frac", "float", 0.5),
    OptionSpec("memory_budget", "budget", None),
    OptionSpec("page_bytes", "int", None),
    OptionSpec("prefetch", "flag", False),
    OptionSpec("target_lag", "lag", None, alterable=True),
]


@dataclasses.dataclass(frozen=True)
class ViewOptions(_OptionSchema):
    """Parsed `CREATE CLASSIFICATION VIEW ... WITH (...)` options."""

    policy: str = "eager"
    k: Optional[int] = None                 # default: table's num_classes
    engine: Optional[str] = None            # default: multiview iff k > 1
    buffer_frac: Optional[float] = None     # default: 0.01 iff hybrid
    p: float = 2.0
    q: float = 2.0
    alpha: float = 1.0
    lr: float = 0.1
    l2: float = 1e-4
    cost_mode: str = "measured"
    touch_ns: float = 0.0
    cap_frac: float = 0.5
    memory_budget: Optional[float] = None
    page_bytes: Optional[int] = None
    prefetch: bool = False
    target_lag: Optional[object] = None     # seconds | DOWNSTREAM | None

    specs = {s.name: s for s in _VIEW_SPECS}
    what = "view option"


_TABLE_SPECS = [
    OptionSpec("scale", "float", 0.1),
    OptionSpec("seed", "int", 0),
]


@dataclasses.dataclass(frozen=True)
class TableOptions(_OptionSchema):
    """Parsed `CREATE TABLE ... FROM CORPUS ... WITH (...)` options."""

    scale: float = 0.1
    seed: int = 0

    specs = {s.name: s for s in _TABLE_SPECS}
    what = "CREATE TABLE option"
