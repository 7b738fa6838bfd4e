"""The exact event engine's loop: one persistent block per simulation."""
