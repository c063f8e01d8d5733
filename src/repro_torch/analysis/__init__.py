"""Analysis helpers.  Only the ``guarded_by`` annotation is ported; the
lint gate is a later slice.  Import the submodule directly."""
