"""Contractor-data pipeline: native video decode (``video``), the cursor
sprite (``cursor``) and the sequence loader (``loader``)."""
