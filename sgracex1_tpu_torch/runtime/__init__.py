"""The native host library (``runtime/native``)."""
