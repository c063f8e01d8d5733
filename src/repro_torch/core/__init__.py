"""Index building and search: ``brute``, ``kmeans``, ``two_level``,
``metrics``.  Import the submodules directly; nothing is imported here,
so an unported module can never break the import of a ported one."""
