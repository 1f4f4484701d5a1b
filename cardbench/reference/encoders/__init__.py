"""The plain reference of each encoder, one file an encoder, found by the
name a configuration gives under ``"encoder"``."""
