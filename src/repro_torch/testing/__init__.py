"""Fault injection for the port's robustness paths."""
