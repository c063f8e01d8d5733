"""Training: the port of ``repro/train``.

``optim`` (SGD-M, AdamW, Adafactor, schedules, clipping), ``compression``
(int8 error feedback and the compressed mean over a process group),
``fault`` (watchdog, fault injection, restart supervisor), ``checkpoint``
(the reference's on-disk layout, leaf for leaf), ``loop`` (the train step
and the loop) and ``sparse_embed`` (row-wise AdaGrad on the gathered rows
of the CTR tables).  Trees are nested dicts of tensors, walked in sorted
key order as ``jax.tree`` walks them (``tree``).  Import the submodules
directly.
"""
