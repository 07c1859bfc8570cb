"""Serving entry points of the port (``serve``) and their step functions
(``steps``); counterpart of ``src/repro/launch``."""
