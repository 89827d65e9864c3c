"""Corpus parsing, offline features and the training loader."""
