"""Utilities: serving counters and the cooperative device lock."""
