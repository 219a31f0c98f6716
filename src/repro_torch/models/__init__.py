"""Model families of the port (``repro.models``): the dense LM for now."""
