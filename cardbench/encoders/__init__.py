"""What the harness knows of each encoder in the port, one file an encoder,
found by the name a configuration gives under ``"encoder"``."""
