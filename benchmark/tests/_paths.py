"""Puts the repository's root on ``sys.path`` so that the tests import
``benchmark`` and the program as ``run.py`` does."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
