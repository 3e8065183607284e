"""Roofline analysis of the dry-run's counts (``analysis.py``) and its
report (``report.py``)."""
