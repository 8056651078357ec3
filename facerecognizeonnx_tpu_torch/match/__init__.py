"""Similarity matching of features."""
