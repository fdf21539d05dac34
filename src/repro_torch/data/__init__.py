"""Data pipelines of the port (``data.pipeline``)."""
