"""Metrics registry (counters / gauges / histograms) with a Prometheus
text-exposition endpoint.

Counterpart of deeperspeed_tpu/monitor/metrics.py: the same
instruments, metric names and exposition text byte for byte.

The registry is the single collection surface: ``serving/metrics.py``
records into it, the stdlib ``http.server`` thread serves it at
``/metrics`` in Prometheus exposition format 0.0.4 (scrapeable by any
Prometheus/Grafana-agent), and the same snapshot exports periodically
through the existing ``TensorBoardMonitor`` so serving dashboards and
training dashboards stay one system.

Instruments follow the Prometheus data model:

  * ``Counter`` — monotone; rendered as ``name_total``-style samples.
  * ``Gauge``   — last-write-wins scalar.
  * ``Histogram`` — FIXED bucket bounds chosen at creation (cumulative
    ``le`` buckets + ``_sum`` + ``_count``); fixed buckets keep the
    per-observation cost to a bisect + two adds, no allocation.

Labels are static per child: ``registry.counter("finished_total",
labels={"reason": "eos"})`` returns the child for that label set; render
groups children under one ``# TYPE`` header, as the format requires.

Everything is stdlib-only and thread-safe (one lock per registry; the
GIL makes the instrument fast paths near-free).
"""

import bisect
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "export_to_tensorboard",
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_SAVE_BUCKETS",
    "DEFAULT_STALL_BUCKETS",
]

# seconds; spans sub-ms decode steps to multi-second TTFT tails. The
# 0.1–10 s range is deliberately dense: that is where serving TTFT/E2E
# tails live (cold prefill buckets, HOL blocking, retry backoff), and a
# p99 estimated from histogram buckets is only as sharp as the bucket
# walls around it.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.25, 0.35,
    0.5, 0.75, 1.0, 1.5, 2.5, 3.5, 5.0, 7.5, 10.0, 15.0, 30.0,
)

# seconds; checkpoint write+commit wall time — tiny CPU-test saves up to
# multi-minute full-model writes on a slow disk
DEFAULT_SAVE_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0,
)

# seconds; per-step host-blocked input wait (datapipe) — a healthy
# prefetched pipe sits in the sub-ms buckets, a host-bound one in the
# tens/hundreds of ms
DEFAULT_STALL_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _sanitize(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalnum() or ch in "_:"
        if ch.isdigit() and i == 0:
            out.append("_")
        out.append(ch if ok else "_")
    return "".join(out)


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        parts.append(f'{_sanitize(k)}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    __slots__ = ("labels", "_value", "_lock")

    def __init__(self, labels=None):
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _samples(self, name):
        return [(name, self.labels, self._value)]


class Gauge:
    __slots__ = ("labels", "_value", "_lock")

    def __init__(self, labels=None):
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _samples(self, name):
        return [(name, self.labels, self._value)]


class Histogram:
    __slots__ = ("labels", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 labels=None):
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        if sorted(set(b)) != b:
            raise ValueError(f"duplicate histogram bucket bounds: {b}")
        self.labels = labels
        self.buckets = tuple(b)
        self._counts = [0] * (len(b) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            self._counts[i] += 1
            self._sum += float(value)
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _samples(self, name):
        out = []
        cum = 0
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        for bound, c in zip(self.buckets, counts):
            cum += c
            le = dict(self.labels or {}, le=_fmt_value(bound))
            out.append((f"{name}_bucket", le, cum))
        out.append((f"{name}_bucket", dict(self.labels or {}, le="+Inf"),
                    total))
        out.append((f"{name}_sum", self.labels, s))
        out.append((f"{name}_count", self.labels, total))
        return out


_TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class MetricsRegistry:
    """Name -> instrument family; families with labels hold one child per
    label set."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, help, {label_key: instrument})
        self._families: Dict[str, Tuple[type, str, Dict]] = {}

    def _get(self, cls, name: str, help: str, labels, **kw):
        name = _sanitize(name)
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (cls, help, {})
                self._families[name] = fam
            if fam[0] is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{_TYPES[fam[0]]}, not {_TYPES[cls]}")
            inst = fam[2].get(key)
            if inst is None:
                inst = cls(labels=dict(labels) if labels else None, **kw)
                fam[2][key] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -------------------------------------------------------------- #

    def collect(self) -> Dict[str, Tuple[str, str, List]]:
        """name -> (type, help, [(sample_name, labels, value), ...])."""
        with self._lock:
            families = {n: (f[0], f[1], list(f[2].values()))
                        for n, f in self._families.items()}
        out = {}
        for name, (cls, help, children) in families.items():
            samples = []
            for child in children:
                samples.extend(child._samples(name))
            out[name] = (_TYPES[cls], help, samples)
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for name, (typ, help, samples) in sorted(self.collect().items()):
            if help:
                esc = help.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {name} {esc}")
            lines.append(f"# TYPE {name} {typ}")
            for sname, labels, value in samples:
                lines.append(f"{sname}{_fmt_labels(labels)} "
                             f"{_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def snapshot_scalars(self, prefix: str = "") -> Dict[str, float]:
        """Flat scalar view (histograms as mean/count) for TensorBoard."""
        out = {}
        for name, (typ, _help, samples) in self.collect().items():
            if typ == "histogram":
                by_suffix = {}
                for sname, labels, value in samples:
                    by_suffix.setdefault(sname, []).append((labels, value))
                for (labels_c, count), (labels_s, total) in zip(
                        by_suffix.get(f"{name}_count", []),
                        by_suffix.get(f"{name}_sum", [])):
                    tag = prefix + name + _fmt_labels(labels_c)
                    out[tag + "_count"] = float(count)
                    if count:
                        out[tag + "_mean"] = float(total) / count
            else:
                for sname, labels, value in samples:
                    out[prefix + sname + _fmt_labels(labels)] = float(value)
        return out


def export_to_tensorboard(registry: MetricsRegistry, monitor,
                          step: int, prefix: str = "Monitor/") -> None:
    """Push the registry snapshot through a TensorBoardMonitor (the same
    scalar surface the training engine writes to)."""
    if monitor is None:
        return
    monitor.write_scalars(registry.snapshot_scalars(prefix), step)


# ------------------------------------------------------------------ #
# the /metrics endpoint
# ------------------------------------------------------------------ #


class MetricsServer:
    """Prometheus scrape endpoint on a daemon ``http.server`` thread.

    Port 0 binds an ephemeral port (see ``.port`` after ``start()``) —
    what the tests use; production configs pin one. The default host is
    loopback; set ``host="0.0.0.0"`` explicitly to expose beyond the pod.
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None

    def start(self) -> "MetricsServer":
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = registry.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # keep scrapes out of stderr
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-endpoint",
            daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
