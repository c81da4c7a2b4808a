"""Deck, initial-condition, results-directory, VTU/PVD, CSV and ExodusII
IO of the drivers (host code; arrays in and out are NumPy)."""

from . import csv_metrics, dat, exodus, provenance
from .getpot import Deck, export_integers
from .vtu import ParaviewWriter

__all__ = ["Deck", "export_integers", "dat", "ParaviewWriter", "csv_metrics",
           "exodus", "provenance"]
