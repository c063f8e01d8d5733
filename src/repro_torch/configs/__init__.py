"""Corpus configurations (``ann_corpora``)."""
