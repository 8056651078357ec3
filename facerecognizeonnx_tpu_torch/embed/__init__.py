"""Alignment and embedding of detected faces."""
