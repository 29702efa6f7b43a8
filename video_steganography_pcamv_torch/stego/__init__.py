"""Stego cost assignment and embedding of the port."""
