"""Checks on what a call of the port reaches (twin of part of ``repro.analysis``)."""
