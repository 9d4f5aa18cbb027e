"""Prometheus text exposition of the port's registry: format 0.0.4, or
OpenMetrics with histogram-bucket exemplars (``holo_tpu``'s
``render_text``, byte for byte).

Only the renderer is here: the HTTP endpoint and the gNMI leaf are the
daemon's, and a launcher that runs the daemon over the port can append this
text to the daemon's scrape.
"""

from __future__ import annotations

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# Exemplars are an OpenMetrics feature: the 0.0.4 grammar allows only
# `value [timestamp]` after the labels, so a 0.0.4 scrape never sees them.
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labelstr(names, values, extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape(str(v))}"' for n, v in zip(names, values)] + [
        f'{n}="{_escape(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _exemplar_str(ex: tuple) -> str:
    """OpenMetrics exemplar suffix `` # {k="v"} value`` of a bucket line."""
    pairs, value = ex
    labels = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return f" # {{{labels}}} {_fmt_value(value)}"


def render_text(registry, openmetrics: bool = False) -> str:
    """The whole registry in Prometheus exposition format.

    ``openmetrics=True`` also renders the histogram-bucket exemplars; the
    caller appends ``# EOF`` when it serves the OpenMetrics content type."""
    lines: list[str] = []
    for fam in registry.families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        children = fam.children()
        if not children and not fam.labelnames:
            # A declared label-less family renders its zero value.
            children = [((), fam.labels())]
        for key, child in children:
            if fam.kind == "histogram":
                exemplars = child.exemplars() if openmetrics else {}
                for le, acc in child.cumulative():
                    ex = exemplars.get(le)
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labelstr(fam.labelnames, key, (('le', _fmt_value(le)),))}"
                        f" {acc}{_exemplar_str(ex) if ex else ''}")
                base = _labelstr(fam.labelnames, key)
                lines.append(f"{fam.name}_sum{base} {_fmt_value(child.sum)}")
                lines.append(f"{fam.name}_count{base} {child.count}")
            else:
                lines.append(f"{fam.name}{_labelstr(fam.labelnames, key)} "
                             f"{_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"
