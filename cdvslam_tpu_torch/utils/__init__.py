"""Utilities: the port's tracer (``utils.trace``)."""
