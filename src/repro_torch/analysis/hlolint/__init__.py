"""hlolint for the port: contracts at the hot entry points, checked
against a run of each.

tracelint (``repro_torch.analysis.tracelint``) guards the source; hlolint
guards what an entry point does when it runs: its in-place state, the
moves between groups, dtypes, host reads and each kernel's calls per
dispatch. See ``checks.py``.

Usage: ``python -m repro_torch.analysis.hlolint`` (on the card; ``--device
cpu`` or ``meta`` to ask for another device). Exit 0 clean / 1 findings /
2 broken contracts, as tracelint.
"""
from repro_torch.analysis.hlolint.contract import (  # noqa: F401
    CollectiveContract,
    CollectiveRule,
    EntrypointContract,
)
