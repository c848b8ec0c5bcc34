"""The port's static and run-time linters: ``tracelint`` (an AST linter
over the source) and ``hlolint`` (contracts at the hot entry points,
checked against a run). Counterpart of ``repro/analysis/``."""
