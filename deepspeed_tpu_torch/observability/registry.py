"""Unified metrics registry: one declaration table and one
``snapshot()``/``export()`` path over every metric namespace the stack
emits (``serving/*``, ``fleet/*``, ``resilience/*``, the router rollup).

Counterpart of ``deepspeed_tpu/observability/registry.py``, with its names and behaviour
(the port keeps its own copy: it imports nothing of the JAX package).

Before this layer each subsystem invented its own namespace ad hoc — a
typo'd name (``serving/prefx_hits``) silently became a new series and
nothing ever cross-checked the strings.  Now:

* every metric NAME is **declared** once (:meth:`MetricsRegistry.counter`
  / ``gauge`` / ``histogram``; families of derived names declare a
  trailing-``*`` pattern, e.g. ``fleet/deaths_*``).  Declarations are the
  machine-readable contract ``analysis/metrics_lint.py`` checks every
  string literal in the package against at lint time;
* metrics **providers** (a scheduler's ``ServingMetrics``, a fleet's
  ``FleetMetrics``, a loop's ``ResilienceMetrics``) register a snapshot
  callable; :meth:`snapshot` merges them, :meth:`export` fans the merged
  scalars out through the existing monitor writers (TensorBoard / WandB /
  CSV) with the same wall-clock-x contract the writers already honor;
* :meth:`to_prometheus` renders a text exposition (``# HELP``/``# TYPE``
  + sanitized names) so an HTTP scrape endpoint is one file read away.

Undeclared names observed at runtime are collected in ``unknown_names``
(never dropped — telemetry must not eat data) so the runtime complement
of the lint is one assert in a test.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

KINDS = ("counter", "gauge", "histogram")

#: prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric name (or trailing-``*`` family pattern)."""

    name: str
    kind: str = "gauge"
    help: str = ""
    unit: str = ""

    @property
    def is_pattern(self) -> bool:
        return self.name.endswith("*")

    @property
    def prefix(self) -> str:
        return self.name[:-1] if self.is_pattern else self.name

    def matches(self, name: str) -> bool:
        if self.is_pattern:
            return name.startswith(self.prefix)
        return name == self.name


class MetricsRegistry:
    """See module doc.  A process-global default instance backs the
    declaration table (declarations happen at module import); ad-hoc
    instances work too (tests, isolated benches)."""

    _default: Optional["MetricsRegistry"] = None
    #: the DECLARATION table is one process-global contract (modules
    #: declare their names at import time, the lint checks against it);
    #: providers/values stay per-instance.  ``isolated=True`` gives a
    #: private table (declaration-mechanics tests).
    _shared_specs: Dict[str, MetricSpec] = {}

    def __init__(self, isolated: bool = False):
        self._specs: Dict[str, MetricSpec] = (
            {} if isolated else MetricsRegistry._shared_specs)
        self._providers: Dict[str, Callable[[], Dict[str, float]]] = {}
        #: names a provider emitted that match NO declaration — the
        #: runtime complement of the metric-name lint
        self.unknown_names: set = set()

    @classmethod
    def default(cls) -> "MetricsRegistry":
        if cls._default is None:
            cls._default = cls()
        return cls._default

    # -- declarations --------------------------------------------------- #
    def declare(self, name: str, kind: str = "gauge", help: str = "",
                unit: str = "") -> MetricSpec:
        if kind not in KINDS:
            raise ValueError(f"declare({name!r}): kind must be one of "
                             f"{KINDS}, got {kind!r}")
        spec = MetricSpec(name, kind, help, unit)
        prev = self._specs.get(name)
        if prev is not None and prev.kind != kind:
            raise ValueError(
                f"metric {name!r} re-declared as {kind} (was {prev.kind})")
        self._specs[name] = spec
        return spec

    def counter(self, name: str, help: str = "", unit: str = ""):
        return self.declare(name, "counter", help, unit)

    def gauge(self, name: str, help: str = "", unit: str = ""):
        return self.declare(name, "gauge", help, unit)

    def histogram(self, name: str, help: str = "", unit: str = ""):
        """Declared for pre-aggregated percentile families (the stack
        exports p50/p95 scalars, not raw buckets) — exposition renders
        them as a quantile-labeled **summary** family, the spec-valid
        form that keeps the kind visible on a scrape."""
        return self.declare(name, "histogram", help, unit)

    def lookup(self, name: str) -> Optional[MetricSpec]:
        """Exact declaration, else the longest matching ``*`` family."""
        spec = self._specs.get(name)
        if spec is not None:
            return spec
        best = None
        for s in self._specs.values():
            if s.is_pattern and s.matches(name):
                if best is None or len(s.prefix) > len(best.prefix):
                    best = s
        return best

    def declared(self) -> List[MetricSpec]:
        return sorted(self._specs.values(), key=lambda s: s.name)

    def declared_names(self) -> List[str]:
        return sorted(self._specs)

    # -- providers ------------------------------------------------------ #
    def register_provider(self, key: str,
                          fn: Callable[[], Dict[str, float]]) -> None:
        """``fn()`` returns fully-namespaced ``{name: value}`` scalars.
        Re-registering a key replaces the provider (a respawned replica
        supersedes its dead incarnation)."""
        self._providers[key] = fn

    def unregister_provider(self, key: str) -> None:
        self._providers.pop(key, None)

    @property
    def providers(self) -> List[str]:
        return sorted(self._providers)

    # -- the one snapshot/export path ----------------------------------- #
    def snapshot(self) -> Dict[str, float]:
        """Merged scalars from every provider.  A raising provider is
        skipped (one sick replica must not blind the whole scrape) and
        undeclared names are recorded, never dropped."""
        out: Dict[str, float] = {}
        for key in sorted(self._providers):
            try:
                vals = self._providers[key]()
            except Exception:  # noqa: BLE001 — a dead provider is data
                out[f"registry/provider_error_{key}"] = 1.0
                continue
            for name, v in vals.items():
                if self.lookup(name) is None:
                    self.unknown_names.add(name)
                out[name] = float(v)
        return out

    def export(self, monitor=None, now: Optional[float] = None
               ) -> List[Tuple[str, float, float]]:
        """Fan the merged snapshot out through the monitor writers with
        a wall-clock float x (the contract ServingMetrics.export set)."""
        wall = time.time() if now is None else now
        events = [(k, v, wall) for k, v in sorted(self.snapshot().items())]
        if monitor is not None and getattr(monitor, "enabled", False):
            monitor.write_events(events)
        return events

    # -- exposition ----------------------------------------------------- #
    @staticmethod
    def prom_name(name: str) -> str:
        out = _PROM_BAD.sub("_", name)
        if out and out[0].isdigit():
            out = "_" + out
        return out

    #: percentile-name convention: ``serving/p50_ttft_s`` is the 0.50
    #: quantile of the ``serving/ttft_s`` series
    _PCTL = re.compile(r"^(?P<head>.*/)p(?P<q>\d{2,3})_(?P<tail>.+)$")

    def to_prometheus(self, values: Optional[Dict[str, float]] = None
                      ) -> str:
        """Prometheus text exposition (v0.0.4) of ``values`` (default:
        a fresh :meth:`snapshot`).

        Histogram-kind declarations (the pre-aggregated percentile
        families, named ``.../p50_x`` / ``.../p95_x`` by convention)
        render as a **summary** family with ``quantile`` labels —
        ``serving_ttft_s{quantile="0.50"}`` — which is the one
        spec-valid exposition for pre-aggregated quantiles (a bare
        sample under ``# TYPE ... histogram`` parses as an EMPTY
        histogram plus a duplicate unknown family and strict scrapers
        reject it; rendering as ``gauge`` — the old behavior — made
        them indistinguishable from plain gauges).  Histogram-kind
        names outside the percentile convention fall back to
        ``untyped``.  Samples are grouped per family with one
        ``# HELP``/``# TYPE`` each, so the page is self-describing and
        scrape-parseable end to end."""
        if values is None:
            values = self.snapshot()
        # (family prom-name, sort key, kind, help, sample line)
        entries: List[Tuple[str, str, str, str, str]] = []
        for name in sorted(values):
            spec = self.lookup(name)
            v = float(values[name])
            kind = "untyped" if spec is None else spec.kind
            help_ = spec.help if spec is not None else ""
            if kind == "histogram":
                m = self._PCTL.match(name)
                if m:
                    fam = self.prom_name(m.group("head")
                                         + m.group("tail"))
                    q = f"0.{m.group('q')}"
                    entries.append(
                        (fam, q, "summary", help_,
                         f'{fam}{{quantile="{q}"}} {v:g}'))
                    continue
                kind = "untyped"      # no quantile convention to honor
            pname = self.prom_name(name)
            entries.append((pname, "", kind, help_, f"{pname} {v:g}"))
        lines: List[str] = []
        seen: set = set()
        for fam, _q, kind, help_, sample in sorted(entries):
            if fam not in seen:
                seen.add(fam)
                if help_:
                    lines.append(f"# HELP {fam} {help_}")
                lines.append(f"# TYPE {fam} {kind}")
            lines.append(sample)
        return "\n".join(lines) + "\n"


def default_registry() -> MetricsRegistry:
    return MetricsRegistry.default()
