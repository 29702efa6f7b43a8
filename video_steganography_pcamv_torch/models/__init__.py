"""The flagship P-frame steps (port of models/): `pipeline`."""
