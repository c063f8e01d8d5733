"""Launch helpers: the meshes of a ``torch.distributed`` world
(``mesh``).  Import the submodules directly."""
