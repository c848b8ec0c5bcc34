"""tracelint for the port: a syntactic linter of the port's rules (host
reads in hot modules, explicit generators, in-place state, mesh axes,
counted kernel launches, process-wide settings).

Run ``python -m repro_torch.analysis.tracelint`` (default path
``src/repro_torch``, default baseline ``tracelint-torch-baseline.txt``).
"""
from repro_torch.analysis.tracelint.config import LintConfig
from repro_torch.analysis.tracelint.engine import (BaselineEntry, Finding,
                                                   LintModule, run)

__all__ = ["BaselineEntry", "Finding", "LintModule", "LintConfig", "run"]
