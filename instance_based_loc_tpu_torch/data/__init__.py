"""Procedural synthetic RGB-D scenes (numpy)."""
