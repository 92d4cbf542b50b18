"""Command-line drivers (the reference's Examples/)."""
