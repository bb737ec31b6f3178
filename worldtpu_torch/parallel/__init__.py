"""Batched (utterance-axis) entry points."""
