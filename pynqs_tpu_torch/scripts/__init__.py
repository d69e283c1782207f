"""Evaluation scripts of the port, as functions (counterparts of ``scripts/``)."""
