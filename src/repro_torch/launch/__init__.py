"""Step functions of the port (``steps``)."""
