"""Prometheus text-exposition parsing (the port's own copy of
``paddle_tpu/observability/promparse.py``: pure stdlib, no package
imports).

``parse_text(text)`` returns a snapshot-shaped dict — the same schema
``MetricsRegistry.snapshot()`` produces (``counters``/``gauges``/
``histograms`` keyed ``name{k=v,...}`` with sorted, unescaped labels) —
plus ``types``/``help`` maps carrying the ``# TYPE`` / ``# HELP``
metadata, and for histograms-as-summaries the parsed p50/p90/p99 +
sum/count (+ derived mean). ``scrape(url)`` GETs ``<url>/metrics`` and
parses the body.

Label values round-trip through the exposition escaping rules
(``\\`` / ``\"`` / ``\n``), matching ``registry._prom_labels`` — tested
end to end in ``tests/test_fleetobs.py``.
"""
import collections
import re
import urllib.request

_SAMPLE_RE = re.compile(
    r'^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_QUANTILE_TO_PCTL = {'0.5': 'p50', '0.9': 'p90', '0.99': 'p99'}


def unescape_label(v):
    """Invert the exposition escaping (``\\\\`` / ``\\"`` / ``\\n``)."""
    return (v.replace('\\\\', '\x00').replace('\\"', '"')
            .replace('\\n', '\n').replace('\x00', '\\'))


def parse_labels(raw):
    """``k1="v1",k2="v2"`` → dict with unescaped values."""
    return {k: unescape_label(v) for k, v in _LABEL_RE.findall(raw or '')}


def fmt_key(name, labels):
    """Canonical snapshot key: ``name`` or ``name{k=v,...}`` (sorted) —
    the same shape ``registry.fmt_key`` emits."""
    if not labels:
        return name
    inner = ','.join(f'{k}={v}' for k, v in sorted(labels.items()))
    return f'{name}{{{inner}}}'


def parse_text(text):
    """Parse a Prometheus text exposition into a snapshot-shaped dict.

    Returns ``{'counters': {key: num}, 'gauges': {key: num},
    'histograms': {key: {count,sum,mean,p50,p90,p99}}, 'types':
    {name: type}, 'help': {name: help_text}}``. Summary quantiles other
    than 0.5/0.9/0.99 are dropped (the registry only exports those
    three); unparseable lines are skipped, never fatal — a scrape of a
    foreign exporter degrades instead of raising.
    """
    types, helps, key_labels = {}, {}, {}
    snap = {'counters': {}, 'gauges': {}, 'histograms': {}}
    summaries = collections.defaultdict(dict)
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith('#'):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == 'TYPE':
                types[parts[2]] = parts[3].strip()
            elif len(parts) >= 3 and parts[1] == 'HELP':
                helps[parts[2]] = unescape_label(
                    parts[3] if len(parts) > 3 else '')
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_val = m.groups()
        try:
            val = float(raw_val)
        except ValueError:
            continue
        if val == int(val):
            val = int(val)
        labels = parse_labels(raw_labels)
        quantile = labels.pop('quantile', None)
        base, field = name, None
        if name.endswith('_sum') and types.get(name[:-4]) == 'summary':
            base, field = name[:-4], 'sum'
        elif name.endswith('_count') and types.get(name[:-6]) == 'summary':
            base, field = name[:-6], 'count'
        elif quantile is not None:
            field = _QUANTILE_TO_PCTL.get(quantile)
            if field is None:
                continue
        key = fmt_key(base, labels)
        key_labels[key] = labels
        if field is not None:
            summaries[key][field] = val
        elif types.get(name) == 'gauge':
            snap['gauges'][key] = val
        else:
            snap['counters'][key] = val
    for key, st in summaries.items():
        if st.get('count'):
            st['mean'] = st.get('sum', 0.0) / st['count']
        snap['histograms'][key] = st
    snap['types'] = types
    snap['help'] = helps
    # exact per-key label dicts: consumers (the federator) must not have
    # to re-split canonical keys, which would corrupt label values that
    # themselves contain ',' or '='
    snap['labels'] = key_labels
    return snap


def scrape(url, timeout=10):
    """GET ``<url>/metrics`` (appending the path when absent) and parse
    the body with :func:`parse_text`."""
    if not url.rstrip('/').endswith('/metrics'):
        url = url.rstrip('/') + '/metrics'
    with urllib.request.urlopen(url, timeout=timeout) as r:
        text = r.read().decode('utf-8')
    return parse_text(text)


def split_key(key):
    """Invert :func:`fmt_key`: ``name{k=v,...}`` → ``(name, labels)``.
    Label VALUES here are already unescaped; splitting is on the raw
    ``,``/``=`` separators, which the registry's own keys never contain
    escaped (keys are canonical, not exposition text)."""
    if '{' not in key:
        return key, {}
    name, inner = key.split('{', 1)
    inner = inner.rstrip('}')
    labels = {}
    for part in inner.split(','):
        if '=' in part:
            k, v = part.split('=', 1)
            labels[k] = v
    return name, labels
