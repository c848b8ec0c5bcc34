"""The benchmark's own CPU tests: ``python -m pytest bench/tests`` from the
repository's root (``tests/`` holds the program's). Puts the root and
``src`` on the path, as ``bench/run.py`` does."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
