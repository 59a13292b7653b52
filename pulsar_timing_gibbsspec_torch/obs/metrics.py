"""Prometheus text-format exposition over the telemetry registry.

The port's copy of ``pulsar_timing_gibbsspec_tpu/obs/metrics.py``: a
dependency-free writer for the 0.0.4 text format.  Counters and gauges
of :mod:`..runtime.telemetry` (including its labeled composite keys,
which already use the Prometheus ``name{k="v"}`` syntax) render into
one scrape body (:func:`render`, :func:`render_telemetry`).
"""

from __future__ import annotations

import math
import re

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_KEY_RE = re.compile(r"^([^{]+)(?:\{(.*)\})?$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def sanitize(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    return "_" + name if name[:1].isdigit() else name


_UNESC = re.compile(r"\\(.)")
_UNESC_MAP = {"n": "\n", "r": "\r"}


def _unescape(v: str) -> str:
    return _UNESC.sub(
        lambda m: _UNESC_MAP.get(m.group(1), m.group(1)), v)


def split_key(key: str):
    """``'name{a="b"}'`` -> ``('name', {'a': 'b'})``; plain names pass
    through with empty labels.  Inverse of ``telemetry.labeled``: label
    values are unescaped here (the renderer re-escapes on the way out)."""
    m = _KEY_RE.match(key)
    if not m:
        return key, {}
    labels = ({k: _unescape(v) for k, v in _LABEL_RE.findall(m.group(2))}
              if m.group(2) else {})
    return m.group(1), labels


def _fmt(v: float) -> str:
    """Prometheus 0.0.4 sample-value spelling: non-finite floats must be
    ``NaN``/``+Inf``/``-Inf`` (Python's ``nan``/``inf`` are invalid)."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _escape(v: str) -> str:
    """Label-value escaping for the exposition body.  Beyond the spec's
    ``\\``/``"``/``\\n`` set, a bare ``\\r`` is escaped as well: label
    values here can arrive from the network path (tenant/job names via
    the gateway), and an unescaped carriage return would let a hostile
    name split a sample line and forge metrics on line-oriented
    scrapers."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n").replace("\r", "\\r")


def _render_family(out, seen, name, labels, value, kind, prefix):
    metric = sanitize(f"{prefix}_{name}" if prefix else name)
    if metric not in seen:
        out.append(f"# TYPE {metric} {kind}")
        seen.add(metric)
    if labels:
        lab = ",".join(f'{sanitize(k)}="{_escape(v)}"'
                       for k, v in sorted(labels.items()))
        out.append(f"{metric}{{{lab}}} {value}")
    else:
        out.append(f"{metric} {value}")


def render(counts=None, gauges=None, prefix: str = "ptgibbs") -> str:
    """Render counter/gauge dicts (telemetry ``snapshot()``/``gauges()``
    shapes — possibly with labeled composite keys) as a Prometheus
    scrape body."""
    out: list = []
    seen: set = set()
    for key, v in sorted((counts or {}).items()):
        name, labels = split_key(key)
        _render_family(out, seen, name + "_total", labels, int(v),
                       "counter", prefix)
    for key, v in sorted((gauges or {}).items()):
        name, labels = split_key(key)
        _render_family(out, seen, name, labels, _fmt(v), "gauge", prefix)
    return "\n".join(out) + ("\n" if out else "")


def render_telemetry(prefix: str = "ptgibbs") -> str:
    """One-call scrape body of the live process-wide registry."""
    from ..runtime import telemetry

    return render(telemetry.snapshot(), telemetry.gauges(), prefix=prefix)
