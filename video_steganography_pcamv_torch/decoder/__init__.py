from .decoder import decode_annexb  # noqa: F401
