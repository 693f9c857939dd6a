"""The port's benchmarks: the counterparts of ``repro``'s ``benchmarks/``.

``telemetry_report`` — per-layer analytic-vs-measured records
                       (``collect_bench``, the bench record's core);
``check_regression`` — the regression gate over a bench record;
``run``              — the paper's analytic tables and ``--bench-json``;
``paper_figures``    — the tables of the paper's figures (analytic);
``kernel_bench``     — every kernel at the main paths' shapes, cold L2,
                       beside its plain version, bound and library call;
``roofline``, ``make_experiments_md`` — tables of the dry run's records;
``timer``            — the cold-L2 CUDA-event timer they all use.

Import from the submodules.
"""
