"""Evaluation helpers of the port (embedding computation)."""
