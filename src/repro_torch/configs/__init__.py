"""Architecture configs of the port (``repro.configs``)."""
