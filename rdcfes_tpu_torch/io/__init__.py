"""Deck, initial-condition, results-directory, VTU/PVD and CSV IO of the
drivers (host code; arrays in and out are NumPy)."""

from . import csv_metrics, dat, provenance  # noqa: F401
from .getpot import Deck, export_integers  # noqa: F401
from .vtu import ParaviewWriter  # noqa: F401
