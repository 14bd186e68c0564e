"""The benchmark's harness: cells found by name from ``BENCHMARK.json``,
configurations, traffic mixes, per-layer metric readers and limits found
as files, the one closed-loop window, the trace reduction and the check
against the plain reference."""
