"""Command-line tools: ``codec_cli``, ``make_corpus``, ``matrix_smoke``, the
evaluation harness (``eval_suite``, ``evaluate_all``, ``export_samples``,
``export_serving``), the results tables (``aggregate_results``,
``generate_tables``, ``ablation_tables``), the config tools
(``generate_configs``, ``migrate_configs``) and the timing tools
(``benchmarks/``, ``probes/``)."""
