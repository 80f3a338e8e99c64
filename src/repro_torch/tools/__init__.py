"""repro_torch.tools — command-line tools over the port's observability
layer, each run as a module:

* ``python -m repro_torch.tools.trace_demo`` — a small instrumented fleet
  replay exported as a Chrome trace and a JSONL event log, both
  revalidated, and its ``ReplayReport`` (``--validate TRACE.json``
  re-checks an emitted pair);
* ``python -m repro_torch.tools.bench_compare`` — compare two BENCH JSON
  documents under ``repro_torch.obs.regress``'s tolerances (exit 0 clean,
  1 regressed, 2 not comparable; ``--selftest BENCH.json``).
"""
