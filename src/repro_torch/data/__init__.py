"""Synthetic data: ANN corpora (``synthetic``) and the LM token stream
(``lm``)."""
