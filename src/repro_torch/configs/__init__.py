"""Model configs of the port (``repro.configs``): the dense, moe, hybrid
and ssm families."""
