"""Launchers of the port: the step functions (``steps``), the training
loop (``train``), device meshes (``mesh``) and the serving routes'
checks (``routes``)."""
