"""The benchmark's own tests (python -m pytest portbench/tests from the
repository's root).  Card tests carry the ``gpu`` marker and decide
inside the test whether a card is present."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
