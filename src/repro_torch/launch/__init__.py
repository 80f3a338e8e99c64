"""Launchers of the port: the step functions (``steps``), the training
loop (``train``), device meshes (``mesh``), the dry-run cells' shapes
(``shapes``) and the dry run itself (``dryrun``, a module entry point),
and the serving routes' checks (``routes``)."""
from . import mesh, shapes, steps
