"""repro_torch.obs — bottleneck attribution, request spans, and timeline export.

A pure consumer of the ``repro_torch.trace`` event spine (REP009-clean: fold a
recorded stream post-hoc, or subscribe via ``attach`` — never mutates
engine/metrics state). Three layers:

  * :mod:`repro_torch.obs.spans` — exact per-request latency decomposition;
  * :mod:`repro_torch.obs.windows` — windowed per-worker time-series;
  * :mod:`repro_torch.obs.regimes` — bottleneck regime classification
    (compute/capacity/queue/comms-bound) over worker-windows;

surfaced by :func:`bottleneck_report` / ``python -m repro_torch.obs report`` and
the Perfetto export :func:`to_chrome_trace` / ``python -m repro_torch.obs
perfetto``. See docs/obs.md.
"""
from repro_torch.obs.perfetto import to_chrome_trace
from repro_torch.obs.regimes import (REGIMES, RegimeReport, RegimeRules,
                               WindowVerdict, attribute, classify)
from repro_torch.obs.report import (attach, bottleneck_report, regime_fractions,
                              render_text, span_summary)
from repro_torch.obs.spans import PHASES, Segment, Span, SpanFold, fold_spans
from repro_torch.obs.windows import (DEFAULT_N_WINDOWS, WindowSet, WindowStats,
                               build_windows)

__all__ = [
    "PHASES", "Segment", "Span", "SpanFold", "fold_spans",
    "DEFAULT_N_WINDOWS", "WindowSet", "WindowStats", "build_windows",
    "REGIMES", "RegimeReport", "RegimeRules", "WindowVerdict",
    "attribute", "classify",
    "attach", "bottleneck_report", "regime_fractions", "render_text",
    "span_summary", "to_chrome_trace",
]
