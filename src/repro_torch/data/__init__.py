"""The data pipeline: synthetic corpus, sort-based length bucketing, packing."""
