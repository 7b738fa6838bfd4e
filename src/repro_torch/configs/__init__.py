"""Model configs of the port (``repro.configs``): the dense family so far."""
