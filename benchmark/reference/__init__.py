"""The benchmark's plain references."""
