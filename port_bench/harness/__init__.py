"""The benchmark's harness: discovery by name, the run, the trace and the
check (``port_bench/run.py`` drives it)."""
