"""Synthetic data: ANN corpora (``synthetic``), the LM token stream
(``lm``), recsys batches (``recsys``) and graphs (``graph``)."""
