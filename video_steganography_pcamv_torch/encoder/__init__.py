"""Encoder stages of the port (torch)."""
