"""The benchmark's general code: cell lookup, weights from the seed, the
traffic generator, the measured window, the trace fold, the yardstick's
arithmetic, the comparison that decides ``correct`` and the faults that
its tests plant underneath the program. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own under ``bench/configs``, ``bench/traffic``, ``bench/cells``
and ``bench/metrics``, found by the name ``BENCHMARK.json`` gives it."""
