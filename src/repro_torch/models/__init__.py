"""The models, ported from ``repro.models``: the language models
(``base``, ``layers``, ``embedding``, ``attention``, ``moe``,
``transformer``), the recsys models (``recsys``) and SchNet
(``schnet``)."""
