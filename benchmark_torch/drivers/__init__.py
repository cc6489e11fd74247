"""Drivers of the traffic kinds, one module each."""
